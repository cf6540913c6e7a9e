"""Recurrent networks (counterpart of ``mxnet_tpu/rnn``, reference
python/mxnet/rnn/): the symbolic cells. ``DropoutCell`` / ``ZoneoutCell``
(which wait for ``Dropout``), the RNN checkpoints (``rnn.py``) and
``BucketSentenceIter`` (``io.py``, with ``BucketingModule``) are not
ported yet."""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, FusedRNNCell,
                       GRUCell, LSTMCell, ModifierCell, ResidualCell,
                       RNNCell, RNNParams, SequentialRNNCell)

__all__ = ["BaseRNNCell", "BidirectionalCell", "FusedRNNCell", "GRUCell",
           "LSTMCell", "ModifierCell", "RNNCell", "RNNParams",
           "ResidualCell", "SequentialRNNCell"]

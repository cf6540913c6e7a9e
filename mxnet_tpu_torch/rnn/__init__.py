"""Recurrent networks (counterpart of ``mxnet_tpu/rnn``, reference
python/mxnet/rnn/): the symbolic cells (``rnn_cell``), the bucketed
sentence iterator (``io``) and the RNN checkpoints (``rnn``)."""
from .io import BucketSentenceIter, encode_sentences
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["BaseRNNCell", "BidirectionalCell", "BucketSentenceIter",
           "DropoutCell", "FusedRNNCell", "GRUCell", "LSTMCell",
           "ModifierCell", "RNNCell", "RNNParams", "ResidualCell",
           "SequentialRNNCell", "ZoneoutCell", "do_rnn_checkpoint",
           "encode_sentences", "load_rnn_checkpoint", "save_rnn_checkpoint"]

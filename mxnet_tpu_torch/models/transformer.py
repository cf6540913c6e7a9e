"""Decoder-only transformer LM on the Symbol API.

Counterpart of ``mxnet_tpu/models/transformer.py``, with the same node
and parameter names, so that package's checkpoints (and
``mxnet_tpu_torch.tools.lm.lm_arg_params``) bind unchanged. Attention is
the ``MultiHeadAttention`` op, which always runs the flash-attention
kernels; the reference's ``use_flash`` switch has no counterpart and is
accepted and ignored.
"""
from .. import symbol as sym


def _block(x, num_heads, dm, dff, name, num_kv_heads=0):
    ln1_g = sym.Variable(name + '_ln1_gamma', shape=(dm,))
    ln1_b = sym.Variable(name + '_ln1_beta', shape=(dm,))
    h = sym.LayerNorm(data=x, gamma=ln1_g, beta=ln1_b, name=name + '_ln1')
    # GQA (num_kv_heads < num_heads): k/v projections shrink to
    # num_kv_heads * head_dim
    dkv = dm if not num_kv_heads else dm // num_heads * num_kv_heads
    q = sym.FullyConnected(data=h, num_hidden=dm, flatten=False, no_bias=True,
                           name=name + '_q')
    k = sym.FullyConnected(data=h, num_hidden=dkv, flatten=False,
                           no_bias=True, name=name + '_k')
    v = sym.FullyConnected(data=h, num_hidden=dkv, flatten=False,
                           no_bias=True, name=name + '_v')
    att = sym.MultiHeadAttention(query=q, key=k, value=v, num_heads=num_heads,
                                 num_kv_heads=num_kv_heads, causal=True,
                                 use_rope=True, name=name + '_attn')
    att = sym.FullyConnected(data=att, num_hidden=dm, flatten=False,
                             no_bias=True, name=name + '_o')
    x = x + att
    ln2_g = sym.Variable(name + '_ln2_gamma', shape=(dm,))
    ln2_b = sym.Variable(name + '_ln2_beta', shape=(dm,))
    h = sym.LayerNorm(data=x, gamma=ln2_g, beta=ln2_b, name=name + '_ln2')
    h = sym.FullyConnected(data=h, num_hidden=dff, flatten=False,
                           name=name + '_ffn1')
    h = sym.Activation(data=h, act_type='gelu', name=name + '_gelu')
    h = sym.FullyConnected(data=h, num_hidden=dm, flatten=False,
                           name=name + '_ffn2')
    return x + h


def get_symbol(num_classes=32000, seq_len=512, num_layers=4, num_heads=8,
               model_dim=512, ffn_dim=2048, num_kv_heads=0,
               scalar_loss=False, **kwargs):
    """Decoder LM symbol over (batch, seq) float token ids. scalar_loss=True
    emits a MakeLoss mean-NLL head instead of SoftmaxOutput."""
    data = sym.Variable('data')
    x = sym.Embedding(data=data, input_dim=num_classes, output_dim=model_dim,
                      name='embed')
    for i in range(num_layers):
        x = _block(x, num_heads, model_dim, ffn_dim, 'layer%d' % i,
                   num_kv_heads=num_kv_heads)
    lnf_g = sym.Variable('lnf_gamma', shape=(model_dim,))
    lnf_b = sym.Variable('lnf_beta', shape=(model_dim,))
    x = sym.LayerNorm(data=x, gamma=lnf_g, beta=lnf_b, name='lnf')
    pred = sym.Reshape(data=x, shape=(-1, model_dim))
    pred = sym.FullyConnected(data=pred, num_hidden=num_classes, name='pred')
    label = sym.Reshape(data=sym.Variable('softmax_label'), shape=(-1,))
    if scalar_loss:
        logp = sym.log_softmax(pred, axis=-1)
        onehot = sym.one_hot(label, depth=num_classes)
        nll = sym._mul_scalar(
            sym.mean(sym.sum(sym._mul(logp, onehot), axis=1)), scalar=-1.0)
        return sym.MakeLoss(nll, name='loss')
    return sym.SoftmaxOutput(data=pred, label=label, name='softmax')

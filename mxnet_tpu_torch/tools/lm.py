"""The full-width LM the card scripts drive.

``chip_smoke.py`` and :mod:`mxnet_tpu_torch.tools.profile_generate` serve
the GQA decoder LM of ``bench.py`` (d 2048, 16 heads, 4 kv heads,
ffn 8192, vocab 10000, bench.py's own 4 layers) from seeded random weights
in ``models/transformer.py`` checkpoint naming (``SERVE``: slot rows;
``SERVE_PAGED``: a block pool behind a shared system prompt;
``SERVE_SPEC``: the same traffic served speculatively), and
``chip_smoke.py`` trains it (``TRAIN``: bench.py's SGD hyperparameters,
bf16 compute and batch 32 x 2048, through the fused step
``lm_train_step``). All take the configuration, the weights, the prompts,
the teacher-forced decode runs and the card's identity line from here.
"""
from __future__ import annotations

import contextlib
import os
import subprocess

import numpy as np

LM = {"vocab": 10000, "d_model": 2048, "heads": 16, "kv_heads": 4,
      "ffn": 8192, "layers": 4}
SERVE = {"slots": 4, "prefill_buckets": (128, 512, 2048),
         "max_context": 2304, "max_new_tokens": 32,
         "prompt_lens": (100, 300, 500, 900, 1500, 2000),
         "check_lens": (500, 2000)}
# paged serving: 8 slots over 288 blocks of 16 positions (the positions of
# two unpaged slots at max_context 2304), so short streams pack eight wide
# and long ones wait for blocks; five prompts share a 1000-token system
# prompt (62 full blocks + 8 positions) before their own suffixes, three
# share nothing; ``forced``: the prompts run teacher-forced (the first
# sharer, cold, and a joiner that forks the boundary block)
SERVE_PAGED = {"slots": 8, "num_blocks": 288, "block_tokens": 16,
               "prefill_buckets": (128, 512, 2048), "max_context": 2304,
               "max_new_tokens": 32, "system_len": 1000,
               "suffix_lens": (24, 100, 300, 500, 900),
               "other_lens": (100, 1500, 2000), "forced": (0, 1)}
# speculative serving: SERVE_PAGED's traffic, pool and slots, 64 new
# tokens, k = 4 drafts an iteration (W = 5); the sampled arm draws at
# ``temperature`` from a seed a stream
SERVE_SPEC = dict(SERVE_PAGED, max_new_tokens=64, spec_tokens=4,
                  temperature=0.8)
# bench.py:334's SGD hyperparameters, compute type (bf16 over f32 master
# weights) and batch (32 x 2048: 38 GB on the card); the card-vs-CPU checks
# run 1 x 256 so their CPU side finishes in seconds; ``timed_steps`` more
# Adam steps after the counted ones give the step time
TRAIN = {"batch": 32, "seq": 2048, "sgd_steps": 5, "adam_steps": 3,
         "lr": 0.05, "momentum": 0.9, "wd": 1e-4, "adam_lr": 1e-4,
         "dtype": "bfloat16", "timed_steps": 10,
         "check_batch": 1, "check_seq": 256, "check_steps": 2}
SEED = 0


def lm_symbol(cfg):
    """The LM's training symbol (MakeLoss mean-NLL head, as bench.py)."""
    from .. import models

    return models.get_symbol(
        "transformer-lm", num_classes=cfg["vocab"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], model_dim=cfg["d_model"],
        ffn_dim=cfg["ffn"], num_kv_heads=cfg["kv_heads"], scalar_loss=True)


def lm_predict_symbol(cfg):
    """The LM with its ``SoftmaxOutput`` head: outputs (B*T, vocab)
    probabilities, the label an input the head does not read at
    inference."""
    from .. import models

    return models.get_symbol(
        "transformer-lm", num_classes=cfg["vocab"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], model_dim=cfg["d_model"],
        ffn_dim=cfg["ffn"], num_kv_heads=cfg["kv_heads"])


def lm_train_executor(cfg, batch, seq, device=None, compute_dtype=None):
    """The LM bound for training at (batch, seq) on ``device`` (None = the
    card), computing in ``compute_dtype`` (None: f32): (executor, names of
    the trained arguments in bind order)."""
    sym = lm_symbol(cfg)
    reqs = {n: ("null" if n in ("data", "softmax_label") else "write")
            for n in sym.list_arguments()}
    exe = sym.simple_bind(device, grad_req=reqs, data=(batch, seq),
                          softmax_label=(batch, seq),
                          compute_dtype=compute_dtype)
    return exe, [n for n in sym.list_arguments() if reqs[n] != "null"]


def lm_feed(exe, cfg, seed):
    """Put one seeded batch of token ids into ``exe``'s data and label
    (f32, as MXNet feeds them)."""
    rng = np.random.RandomState(seed)
    for n in ("data", "softmax_label"):
        exe.arg_dict[n][:] = rng.randint(
            0, cfg["vocab"], exe.arg_dict[n].shape).astype(np.float32)


def lm_updater(kind, train, names):
    """An ``optimizer.Updater`` with ``train``'s hyperparameters: ``kind``
    "sgd" (momentum) or "adam"."""
    from .. import optimizer

    idx2name = dict(enumerate(names))
    if kind == "sgd":
        opt = optimizer.SGD(learning_rate=train["lr"],
                            momentum=train["momentum"], wd=train["wd"],
                            param_idx2name=idx2name)
    else:
        opt = optimizer.Adam(learning_rate=train["adam_lr"], wd=train["wd"],
                             param_idx2name=idx2name)
    return optimizer.Updater(opt)


def lm_update(exe, names, updater):
    """A step's updates: one ``updater`` call per trained argument."""
    updater.update_all((i, exe.grad_dict[n], exe.arg_dict[n])
                       for i, n in enumerate(names))


def lm_train_step(exe, names, updater):
    """bench.py's fused step on the port: ``exe.make_train_step`` over
    ``optimizer.FusedUpdate`` (``updater``'s optimizer's ``pure_rule``, the
    per-parameter (lr, wd) from ``effective_lr_wd`` as device arrays).
    Returns (run, step): ``run()`` takes one step and returns its
    outputs."""
    from .. import optimizer

    update = optimizer.FusedUpdate(updater, names)
    step = exe.make_train_step(update)
    params = {n: exe.arg_dict[n]._data for n in names}
    states = update.states(exe.arg_dict)
    device = params[names[0]].device

    def run():
        outs, _, _ = step(params, states, None, *update.lr_wd(device))
        return outs

    return run, step


@contextlib.contextmanager
def cuda_graph(on):
    """Training steps made inside the block are captured as CUDA graphs
    (``on``) or run eagerly: ``MXNET_CUDA_GRAPH``, as it was after."""
    was = os.environ.get("MXNET_CUDA_GRAPH")
    os.environ["MXNET_CUDA_GRAPH"] = "1" if on else "0"
    try:
        yield
    finally:
        if was is None:
            del os.environ["MXNET_CUDA_GRAPH"]
        else:
            os.environ["MXNET_CUDA_GRAPH"] = was


def lm_train_setup(cfg, train, device=None, seed=SEED):
    """The start of the train run that ``chip_smoke.py`` and the profile
    tools drive: the LM bound at ``train``'s batch x seq on ``device``
    (None = the card), computing in ``train["dtype"]``,
    ``Xavier(factor_type="in", magnitude=2)`` from ``seed``, one fixed
    batch from ``seed + 4``. Returns (executor, trained names)."""
    from .. import initializer

    exe, names = lm_train_executor(cfg, train["batch"], train["seq"], device,
                                   train["dtype"])
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    for n in names:
        init(initializer.InitDesc(n), exe.arg_dict[n])
    lm_feed(exe, cfg, seed + 4)
    return exe, names


def lm_param_shapes(cfg):
    """name -> shape of every trained parameter, in checkpoint naming."""
    d, f, v = cfg["d_model"], cfg["ffn"], cfg["vocab"]
    dkv = d // cfg["heads"] * cfg["kv_heads"]
    shapes = {"embed_weight": (v, d)}
    for i in range(cfg["layers"]):
        pre = "layer%d" % i
        shapes.update({
            pre + "_ln1_gamma": (d,), pre + "_ln1_beta": (d,),
            pre + "_q_weight": (d, d), pre + "_k_weight": (dkv, d),
            pre + "_v_weight": (dkv, d), pre + "_o_weight": (d, d),
            pre + "_ln2_gamma": (d,), pre + "_ln2_beta": (d,),
            pre + "_ffn1_weight": (f, d), pre + "_ffn1_bias": (f,),
            pre + "_ffn2_weight": (d, f), pre + "_ffn2_bias": (d,)})
    shapes.update({"lnf_gamma": (d,), "lnf_beta": (d,),
                   "pred_weight": (v, d), "pred_bias": (v,)})
    return shapes


def lm_arg_params(cfg, seed):
    """Seeded random weights in models/transformer.py checkpoint naming;
    matrices scaled 1/sqrt(fan_in) so the greedy argmax is well
    separated, gammas 1, betas and biases 0."""
    rng = np.random.default_rng(seed)
    p = {}
    for name, shape in lm_param_shapes(cfg).items():
        if name == "embed_weight":
            p[name] = rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith("_weight"):
            p[name] = rng.standard_normal(shape, dtype=np.float32) \
                / np.float32(np.sqrt(shape[1]))
        elif name.endswith("_gamma"):
            p[name] = np.ones(shape, np.float32)
        else:
            p[name] = np.zeros(shape, np.float32)
    return p


def serve_prompts(cfg, serve, seed):
    """The serve traffic's prompts (``serve["prompt_lens"]``)."""
    rng = np.random.default_rng(seed + 1)
    return [rng.integers(0, cfg["vocab"], n).tolist()
            for n in serve["prompt_lens"]]


def paged_prompts(cfg, paged, seed):
    """The paged traffic: the system prompt followed by each suffix, then
    the prompts that share nothing. Every suffix starts with a token of
    its own and every unshared prompt with a token no other prompt starts
    with, so two sharers' common prefix is exactly the system prompt and
    an unshared prompt's is empty."""
    rng = np.random.default_rng(seed + 2)
    system = rng.integers(0, cfg["vocab"], paged["system_len"]).tolist()
    firsts = rng.permutation(cfg["vocab"])
    firsts = [int(t) for t in firsts if t != system[0]]
    out = []
    for i, n in enumerate(paged["suffix_lens"]):
        out.append(system + [firsts[i]]
                   + rng.integers(0, cfg["vocab"], n - 1).tolist())
    for i, n in enumerate(paged["other_lens"], len(paged["suffix_lens"])):
        out.append([firsts[i]]
                   + rng.integers(0, cfg["vocab"], n - 1).tolist())
    return out


def expected_prefix_counts(prompts, block_tokens):
    """(prefix_hits, prefix_tokens_saved, cow_forks) that follow from the
    prompts when each is admitted in order while every earlier one is
    still resident: a prompt reuses its longest common prefix with an
    earlier one, short of its last token (which it prefills for its first
    logits), and forks when that prefix ends inside a block."""
    hits = saved = forks = 0
    for i, p in enumerate(prompts):
        lcp = 0
        for q in prompts[:i]:
            k = 0
            while k < min(len(p), len(q)) and p[k] == q[k]:
                k += 1
            lcp = max(lcp, k)
        ctx = min(lcp, len(p) - 1)
        if ctx:
            hits += 1
            saved += ctx
        if ctx % block_tokens:
            forks += 1
    return hits, saved, forks


def _logits_np(t):
    return t.float().cpu().numpy()


def forced_unpaged(progs, prompt, steps, forced=None):
    """Prefill ``prompt`` into slot 0 of fresh slabs of ``progs`` (a
    ``DecodePrograms``), then ``steps`` decode steps of slot 0 (the other
    slots inactive), fed ``forced`` or, when None, each step's argmax
    (greedy). Returns (logits (steps + 1, V) f32, the tokens fed)."""
    slabs = list(progs.fresh_slabs())
    scales = progs.fresh_scale_slabs()
    pre = progs.prefill(prompt)
    if scales:
        progs.admit(*slabs, pre[1], pre[2], 0, ks_slab=scales[0],
                    vs_slab=scales[1], ks_new=pre[3], vs_new=pre[4])
    else:
        progs.admit(*slabs, pre[1], pre[2], 0)
    rows = [_logits_np(pre[0])]
    lengths = np.zeros(progs.slots, np.int64)
    tokens = np.zeros(progs.slots, np.int64)
    lengths[0] = len(prompt)
    fed = []
    for i in range(steps):
        tokens[0] = forced[i] if forced is not None else int(rows[-1].argmax())
        fed.append(int(tokens[0]))
        out = progs.decode(*slabs, lengths, tokens,
                           *(scales if scales else ()))
        rows.append(_logits_np(out[0]))
        lengths[0] += 1
    return np.stack(rows), fed


def forced_paged(progs, cache, prompt, max_new, forced):
    """Admit ``prompt`` into ``cache`` (a ``PagedKVCacheManager`` over
    ``progs``; prompts admitted earlier stay, so their prefixes are
    shared), run its paged prefill, then one decode step a token of
    ``forced`` with every other row inactive. Returns (logits
    (len(forced) + 1, V) f32, the admission plan)."""
    plan = cache.try_admit(prompt, prompt, max_new)
    if plan is None:
        raise RuntimeError("forced_paged: no blocks for a %d-token prompt"
                           % len(prompt))
    scales = {"ks_slab": cache.k_scale, "vs_slab": cache.v_scale}
    rows = [_logits_np(progs.paged_prefill(
        cache.k_slab, cache.v_slab, plan.table, plan.ctx_len, plan.suffix,
        plan.fork_src, plan.fork_dst, **scales))]
    tables = np.zeros((progs.slots, progs.max_blocks), np.int64)
    tables[plan.slot] = plan.table
    lengths = np.zeros(progs.slots, np.int64)
    tokens = np.zeros(progs.slots, np.int64)
    for tok in forced:
        lengths[plan.slot] = cache.length(plan.slot)
        tokens[plan.slot] = tok
        rows.append(_logits_np(progs.decode(
            cache.k_slab, cache.v_slab, tables, lengths, tokens,
            **scales)[plan.slot]))
        cache.advance(plan.slot)
    return np.stack(rows), plan


def forced_verify(progs, prompt, fed, window):
    """Prefill ``prompt`` into slot 0 of fresh slabs of ``progs`` (a
    ``DecodePrograms`` with its verify enabled), then feed ``fed`` (the
    tokens a decode run fed, ``fed[i]`` at position ``len(prompt) + i``)
    through the verify ``window`` at a time, the other slots inactive.
    Returns logits (len(fed), V) f32: row i is the logits after position
    ``len(prompt) + i``, as row i + 1 of :func:`forced_unpaged`."""
    slabs = list(progs.fresh_slabs())
    scales = progs.fresh_scale_slabs()
    pre = progs.prefill(prompt)
    if scales:
        progs.admit(*slabs, pre[1], pre[2], 0, ks_slab=scales[0],
                    vs_slab=scales[1], ks_new=pre[3], vs_new=pre[4])
    else:
        progs.admit(*slabs, pre[1], pre[2], 0)
    lengths = np.zeros(progs.slots, np.int64)
    lengths[0] = len(prompt)
    rows = []
    for i in range(0, len(fed), window):
        chunk = fed[i:i + window]
        wtok = np.zeros((progs.slots, window), np.int64)
        wtok[0, :len(chunk)] = chunk
        out = progs.verify(*slabs, lengths, wtok,
                           *(scales if scales else ()))
        rows.append(_logits_np(out[0, :len(chunk)]))
        lengths[0] += len(chunk)
    return np.concatenate(rows)


def forced_verify_paged(progs, cache, prompt, max_new, fed, window):
    """:func:`forced_verify` through the block tables: admit ``prompt``
    into ``cache`` (a ``PagedKVCacheManager`` over ``progs``, a
    ``PagedDecodePrograms`` with its verify enabled), run its paged
    prefill, then the verify windows. Returns (logits (len(fed), V), the
    admission plan)."""
    plan = cache.try_admit(prompt, prompt, max_new)
    if plan is None:
        raise RuntimeError("forced_verify_paged: no blocks for a %d-token "
                           "prompt" % len(prompt))
    scales = {"ks_slab": cache.k_scale, "vs_slab": cache.v_scale}
    progs.paged_prefill(cache.k_slab, cache.v_slab, plan.table,
                        plan.ctx_len, plan.suffix, plan.fork_src,
                        plan.fork_dst, **scales)
    tables = np.zeros((progs.slots, progs.max_blocks), np.int64)
    tables[plan.slot] = plan.table
    lengths = np.zeros(progs.slots, np.int64)
    lengths[plan.slot] = len(prompt)
    rows = []
    for i in range(0, len(fed), window):
        chunk = fed[i:i + window]
        wtok = np.zeros((progs.slots, window), np.int64)
        wtok[plan.slot, :len(chunk)] = chunk
        out = progs.verify(cache.k_slab, cache.v_slab, tables, lengths,
                           wtok, **scales)
        rows.append(_logits_np(out[plan.slot, :len(chunk)]))
        lengths[plan.slot] += len(chunk)
    return np.concatenate(rows), plan


def forced_arms(gen, model, paged, prompts, kv_dtype="float32",
                capture=False, forced=None):
    """The teacher-forced runs of ``paged["forced"]``'s prompts through
    the unpaged and the paged programs at ``paged``'s configuration, in
    ``kv_dtype``: {"unpaged": [(logits, tokens)...], "paged": [logits...],
    "plans": [...]}; tokens are greedy from the unpaged run unless
    ``forced`` (one token list a prompt) is given. The paged prompts are
    admitted in order into one cache, so a joiner shares and forks."""
    steps = paged["max_new_tokens"] - 1
    unpaged = gen.DecodePrograms(model, paged["slots"],
                                 paged["max_context"],
                                 paged["prefill_buckets"], kv_dtype=kv_dtype,
                                 capture=capture)
    out = {"unpaged": [], "paged": [], "plans": []}
    for i, idx in enumerate(paged["forced"]):
        out["unpaged"].append(forced_unpaged(
            unpaged, prompts[idx], steps,
            None if forced is None else forced[i]))
    progs = gen.PagedDecodePrograms(
        model, paged["slots"], paged["max_context"],
        paged["prefill_buckets"], paged["block_tokens"],
        paged["num_blocks"], kv_dtype=kv_dtype, capture=capture)
    cache = gen.PagedKVCacheManager(progs)
    for (_, toks), idx in zip(out["unpaged"], paged["forced"]):
        logits, plan = forced_paged(progs, cache, prompts[idx],
                                    paged["max_new_tokens"], toks)
        out["paged"].append(logits)
        out["plans"].append(plan)
    out["programs"] = (unpaged, progs)
    out["cache"] = cache
    return out


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()

"""Reference-ecosystem file interop (the port's own copy of
``mxnet_tpu/interop.py``): read (and write) the reference
framework's serialized model formats, so checkpoints from its model zoo
load directly into this framework.

Two stable public formats (SURVEY §2.6 "deployment story"):

1. **Symbol JSON** — the nnvm graph dump written by the reference's
   ``Symbol.save``: ``nodes`` (op/name/attr/inputs), ``arg_nodes``,
   ``heads``, with per-version quirks normalized by its legacy upgrader
   (the reference's src/nnvm/legacy_json_util.cc):
   - pre-0.9 graphs omit auxiliary-state inputs (BatchNorm moving
     stats): they are re-created as ``<node>_<auxname>`` variables
     (UpgradeJSON_000800_000900, legacy_json_util.cc:115-133);
   - "hidden" attribute keys (``lr_mult``/``wd_mult``/``ctx_group``/
     ``force_mirroring``, c_api_symbolic.cc:20-22) appear bare or
     arg-scoped (``weight_lr_mult``) in old files and must not reach the
     op's parameter parser (UpgradeJSON_FixParsing);
   - ``argmin/argmax`` with ``axis="-1"`` predate the optional-axis
     semantics and mean "flatten" (UpgradeJSON_000904_000905).
   Node attr dicts are stored under ``attr`` (0.9.x) or ``attrs``
   (1.x); both are accepted, as are 2- and 3-element input entries.

2. **.params blob** — the dmlc-stream NDArray container
   (src/ndarray/ndarray.cc:616-700): uint64 magic ``0x112`` + uint64
   reserved, a ``vector<NDArray>`` (uint64 count, then per array:
   TShape as uint32 ndim + per-dim extents, Context as int32 dev_type +
   int32 dev_id, int32 type_flag, raw bytes) and a ``vector<string>``
   of names (uint64 count, uint64 length + bytes each). Newer (1.x)
   files tag each array with NDARRAY_V1/V2 magics and widen dims to
   int64 (V2 adds an int32 storage-type field); all three layouts are
   read by sniffing the record's first uint32.

``mxnet_tpu_torch.ndarray.load`` and ``symbol.load_json`` detect
these formats automatically, so ``model.load_checkpoint`` works on a
reference-written checkpoint pair unchanged.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List

import numpy as np

NDLIST_MAGIC = 0x112
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9

# type_flag <-> numpy dtype (mshadow/base.h kFloat32... order)
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
               4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v).name: k for k, v in _TYPE_FLAGS.items()}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, n):
        if self.o + n > len(self.d):
            raise ValueError("reference .params blob truncated at byte %d"
                             % self.o)
        b = self.d[self.o:self.o + n]
        self.o += n
        return b

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def peek_u32(self):
        if self.o + 4 > len(self.d):
            raise ValueError("reference .params blob truncated at byte %d"
                             % self.o)
        return struct.unpack("<I", self.d[self.o:self.o + 4])[0]


def _read_one_ndarray(r: _Reader) -> np.ndarray:
    first = r.peek_u32()
    if first in (_NDARRAY_V1_MAGIC, _NDARRAY_V2_MAGIC):
        r.u32()
        if first == _NDARRAY_V2_MAGIC:
            stype = r.i32()
            if stype != 0:  # kDefaultStorage
                raise ValueError("sparse reference NDArray (stype %d) not "
                                 "supported" % stype)
        ndim = r.u32()
        shape = tuple(struct.unpack("<%dq" % ndim, r.take(8 * ndim)))
    else:
        # legacy (<=0.11): TShape = uint32 ndim + uint32 extents
        ndim = r.u32()
        shape = tuple(struct.unpack("<%dI" % ndim, r.take(4 * ndim)))
    if ndim == 0:
        return np.zeros((), np.float32)
    r.i32()  # Context dev_type (always saved from CPU copy)
    r.i32()  # Context dev_id
    flag = r.i32()
    if flag not in _TYPE_FLAGS:
        raise ValueError("unknown reference dtype flag %d" % flag)
    dt = np.dtype(_TYPE_FLAGS[flag])
    n = int(np.prod(shape, dtype=np.int64))
    return np.frombuffer(r.take(n * dt.itemsize), dt).reshape(shape).copy()


def is_reference_params(head: bytes) -> bool:
    """First 8 bytes == the dmlc NDArray-list magic?"""
    return (len(head) >= 8
            and struct.unpack("<Q", head[:8])[0] == NDLIST_MAGIC)


def load_params(fname_or_bytes):
    """Read a reference ``.params`` blob. Returns a dict name->NDArray
    when the file carries names (``arg:``/``aux:`` prefixes preserved,
    exactly what model.load_checkpoint splits), else a list."""
    from . import ndarray as nd

    if isinstance(fname_or_bytes, bytes):
        data = fname_or_bytes
    else:
        with open(fname_or_bytes, "rb") as f:
            data = f.read()
    r = _Reader(data)
    if r.u64() != NDLIST_MAGIC:
        raise ValueError("not a reference NDArray file (bad magic)")
    r.u64()  # reserved
    arrays = [_read_one_ndarray(r) for _ in range(r.u64())]
    n_names = r.u64()
    names = [r.take(r.u64()).decode() for _ in range(n_names)]
    if names and len(names) != len(arrays):
        raise ValueError("reference .params name/array count mismatch")
    # on the host, as nd.load returns its arrays
    if names:
        return {k: nd.array(v, ctx="cpu") for k, v in zip(names, arrays)}
    return [nd.array(v, ctx="cpu") for v in arrays]


def _host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def save_params(fname: str, data) -> None:
    """Write the legacy dmlc blob (the layout of ndarray.cc:616-639 /
    675-683) so artifacts round-trip back into the reference ecosystem."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [_host(data[k]) for k in names]
    else:
        names = []
        arrays = [_host(v) for v in data]
    out = [struct.pack("<QQ", NDLIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        if a.dtype.name not in _FLAG_OF:
            raise ValueError("dtype %s has no reference type flag (cast "
                             "bf16 etc. first)" % a.dtype)
        out.append(struct.pack("<I", a.ndim))
        out.append(struct.pack("<%dI" % a.ndim, *a.shape))
        out.append(struct.pack("<ii", 1, 0))       # Context: cpu(0)
        out.append(struct.pack("<i", _FLAG_OF[a.dtype.name]))
        out.append(np.ascontiguousarray(a).tobytes())
    out.append(struct.pack("<Q", len(names)))
    for nm in names:
        b = nm.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    with open(fname, "wb") as f:
        f.write(b"".join(out))


# --- symbol JSON ----------------------------------------------------------

_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage", "init")
# legacy -> current op-name aliases seen in old zoo files
_OP_ALIASES = {"ElementWiseSum": "add_n"}


def _split_attrs(op, raw: Dict[str, str]):
    """Separate a reference node's attr dict into (param attrs for
    op.parse_attrs, misc attrs, arg-scoped hidden keys). Mirrors
    UpgradeJSON_FixParsing: hidden keys — bare (``lr_mult``), arg-scoped
    (``weight_lr_mult``, to be relocated onto the named input variable),
    or already ``__wrapped__`` — and anything the parameter struct
    doesn't know must not reach the parser. For variable nodes
    (op=None) every non-hidden attr is a user attribute and stays in
    misc verbatim (the reference's AttrScope storage)."""
    params, misc, arg_scoped = {}, {}, []
    known = set(op.param_spec or ()) if op is not None else set()
    for k, v in raw.items():
        if k.startswith("__") and k.endswith("__"):
            misc[k] = v
            continue
        hit = next((h for h in _HIDDEN_KEYS
                    if k == h or k.endswith("_" + h)), None)
        if hit is not None:
            if k == hit or op is None:
                misc["__%s__" % k] = v
            else:
                # weight_lr_mult on a Conv node belongs to the `weight`
                # input variable as __lr_mult__
                arg_scoped.append((k[:-(len(hit) + 1)], hit, v))
            continue
        if op is not None and k in known:
            params[k] = v
        else:
            # variables: user attrs verbatim; ops: num_args on variadic
            # ops (input count speaks) or attrs from newer reference
            # versions — keep, don't reject
            misc[k] = v
    return params, misc, arg_scoped


def load_symbol_json(json_str):
    """Build a Symbol from reference symbol JSON (any version the
    reference's own legacy upgrader accepts — see module docstring).
    Accepts the raw string or an already-parsed dict."""
    from .base import coerce_attr
    from .ops.registry import get_op
    from . import symbol as sym_mod

    data = (json_str if isinstance(json_str, dict)
            else json.loads(json_str))
    # graphs without a version stamp are pre-0.9 (the reference treats
    # absent as 0 and runs every upgrader)
    ver_attr = (data.get("attrs") or {}).get("mxnet_version")
    version = int(ver_attr[1]) if ver_attr else 0
    jnodes = data["nodes"]
    nodes: List[sym_mod._Node] = []  # indexed like the JSON node list
    for jn in jnodes:
        raw = dict(jn.get("attrs") or jn.get("attr") or jn.get("param")
                   or {})
        name = jn["name"]
        if jn["op"] == "null":
            params, misc, _ = _split_attrs(None, raw)
            misc.update(params)  # defensive: op=None routes all to misc
            nodes.append(sym_mod._Node(None, name, {}, [], False, misc))
            continue
        op = get_op(_OP_ALIASES.get(jn["op"], jn["op"]))
        params, misc, arg_scoped = _split_attrs(op, raw)
        # argmin/argmax axis=-1 predates optional axis and means
        # "flatten" ONLY in pre-0.9.5 files (UpgradeJSON_000904_000905
        # is gated on the version; 1.x uses -1 = last axis)
        if (version < 905 and op.name in ("argmax", "argmin")
                and params.get("axis") == "-1"):
            del params["axis"]
        attrs = op.parse_attrs({k: coerce_attr(v)
                                for k, v in params.items()})
        inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
        node = sym_mod._Node(op, name, attrs, inputs, False, misc)
        # pre-0.9 JSON omits aux-state inputs: recreate them as
        # <node>_<auxname> variables inheriting the node's attrs
        # (UpgradeJSON_000800_000900 + DefaultVarName). Synthesized vars
        # are reachable through node.inputs — they need no slot in
        # `nodes`, which mirrors the JSON indexing for input/head refs.
        aux_names = () if op.variadic else op.get_aux_names(attrs)
        n_args = len(inputs) if op.variadic else len(op.get_arg_names(attrs))
        while len(node.inputs) < n_args + len(aux_names):
            var = sym_mod._Node(
                None, "%s_%s" % (name, aux_names[len(node.inputs) - n_args]),
                {}, [], True, {})
            node.inputs.append((var, 0))
        # mark this op's aux inputs (reference: FMutateInputs positions)
        for child, _ in node.inputs[len(node.inputs) - len(aux_names):]:
            if child.is_var:
                child.is_aux = True
        # relocate arg-scoped hidden keys onto the named input variable
        # (UpgradeJSON_FixParsing's second branch); unmatched names fall
        # back to the op node's misc under the original key (mutate
        # node.misc_attrs, NOT the local dict: _Node replaces a falsy
        # misc with a fresh one at construction)
        if arg_scoped:
            argn = list(op.get_arg_names(attrs)) if not op.variadic else []
            for aname, hid, v in arg_scoped:
                if aname in argn and node.inputs[argn.index(aname)][0].is_var:
                    node.inputs[argn.index(aname)][0].misc_attrs[
                        "__%s__" % hid] = v
                else:
                    node.misc_attrs["%s_%s" % (aname, hid)] = v
        nodes.append(node)
    heads = data.get("heads", data.get("head"))
    entries = [(nodes[e[0]], e[1]) for e in heads]
    return sym_mod.Symbol(entries)


def is_reference_symbol_json(data: dict) -> bool:
    """Our own schema stamps attrs.mxnet_tpu_version; the reference's
    doesn't."""
    attrs = data.get("attrs") or {}
    return "nodes" in data and "mxnet_tpu_version" not in attrs


# write side -----------------------------------------------------------------

_REV_OP_ALIASES = {v: k for k, v in _OP_ALIASES.items()}


def _ref_attr_str(v) -> str:
    """Python attr value -> the reference's dmlc::Parameter string
    spelling ("(5,5)" tuples without spaces, "True"/"False", "None") —
    the forms `coerce_attr` and the reference's own parsers both read."""
    if v is None:
        return "None"
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (tuple, list)):
        return "(%s)" % ",".join(_ref_attr_str(x) for x in v)
    return str(v)


def save_symbol_json(sym, indent: int = 2) -> str:
    """Emit reference-format symbol JSON (``nodes``/``arg_nodes``/
    ``node_row_ptr``/``heads`` + ``attrs.mxnet_version`` — the schema
    the reference's Symbol.save writes and legacy_json_util.cc reads;
    the write-side complement of :func:`load_symbol_json`, closing the
    ecosystem round trip the .params side already has).

    Aux-state inputs are emitted as ordinary variable nodes (the >=0.9
    convention); the reader reconstructs their aux positions from the
    op's own aux-name list. Hidden keys (``__lr_mult__`` etc.) are
    written wrapped, as the reference's C API stores them. Ops that
    exist only in this framework serialize under their own names — this
    repo's reader round-trips them; the reference era would reject them
    exactly as it rejects any unknown op."""
    nodes = sym._nodes()
    idx = {id(n): i for i, n in enumerate(nodes)}
    jnodes = []
    for n in nodes:
        jn = {"op": ("null" if n.is_var
                     else _REV_OP_ALIASES.get(n.op.name, n.op.name)),
              "name": n.name,
              "inputs": [[idx[id(c)], i, 0] for c, i in n.inputs]}
        attr = {}
        if not n.is_var:
            for k, v in n.attrs.items():
                attr[k] = _ref_attr_str(v)
            if n.op.variadic:
                # the reference's variadic ops carry their input count
                attr["num_args"] = str(len(n.inputs))
        for k, v in (n.misc_attrs or {}).items():
            attr[k] = v if isinstance(v, str) else _ref_attr_str(v)
        if attr:
            jn["attr"] = attr
        jnodes.append(jn)
    # node_row_ptr[i+1] = node_row_ptr[i] + num_outputs(node i): the
    # entry-index table graph-runtime consumers use — a flat +1 per node
    # would mis-index any graph with a multi-output op (SliceChannel...)
    row_ptr = [0]
    for n in nodes:
        n_out = 1 if n.is_var else n.op.get_num_outputs(n.attrs)
        row_ptr.append(row_ptr[-1] + n_out)
    return json.dumps(
        {
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "node_row_ptr": row_ptr,
            "heads": [[idx[id(n)], i, 0] for n, i in sym._entries],
            "attrs": {"mxnet_version": ["int", 905]},
        },
        indent=indent,
    )

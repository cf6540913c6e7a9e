"""KVStore: the communication plane.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference src/kvstore/,
python/mxnet/kvstore.py): ``init`` / ``push`` / ``pull`` over int or str
keys, ``set_updater`` / ``set_optimizer``, the optimizer-state files,
``rank`` / ``num_workers`` / ``barrier``, and the factory :func:`create`
(``local``, ``device``, ``local_allreduce_cpu`` / ``_device``,
``dist_sync``, ``dist_device_sync``, ``dist_sync_device``,
``dist_async``).

- ``local`` / ``device``: a push sums the key's values (one a context) on
  the first value's device and runs the updater on the sum against the
  stored weight, which moves to that device at the first push (the
  reference's merge buffer); without an updater the sum replaces the
  stored value. A pull **copies** the stored value into each output
  tensor: the executors' tensors are updated in place and a captured step
  may hold them, so a pull never rebinds them (the JAX package may: its
  arrays are immutable).
- ``dist_*`` (collective): the same, over the process group of
  :mod:`.parallel.dist` (``torch.distributed``): ``init`` broadcasts rank
  0's value, a push all-reduces the locally summed value across the ranks
  before the updater, which every rank then applies alike. ``dist_async``
  behaves as ``dist_sync`` here, as the JAX package's code does (its
  docstring promises a reconciling mean it does not implement).
- :class:`PSKVStore` (a ``dist_*`` type when ``MXNET_TPU_PS_URI`` or
  ``DMLC_PS_ROOT_URI`` names parameter servers): weights live on the
  servers of :mod:`.kvstore_server`; every RPC is an op of the port's
  engine holding its key's variable, a pull waits on one fence over every
  key it pulls, an RPC's error surfaces at the next sync point, and the
  caller's trace context rides the wire.

Telemetry: the counters ``kvstore_push_total``, ``kvstore_push_bytes_total``,
``kvstore_pull_total``, ``kvstore_pull_bytes_total`` and
``kvstore_barrier_total`` in the registry, and the spans
``kvstore.push`` / ``kvstore.pull`` / ``kvstore.barrier`` (domain
``kvstore``).
"""
from __future__ import annotations

import copy
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .ndarray import NDArray
from .parallel import dist as _dist
from .telemetry import context as _trace_context

_push_total = telemetry.registry.counter(
    "kvstore_push_total", help="kvstore push calls (keys)")
_push_bytes = telemetry.registry.counter(
    "kvstore_push_bytes_total", help="gradient bytes pushed")
_pull_total = telemetry.registry.counter(
    "kvstore_pull_total", help="kvstore pull calls (keys)")
_pull_bytes = telemetry.registry.counter(
    "kvstore_pull_bytes_total", help="weight bytes pulled")
_barrier_total = telemetry.registry.counter(
    "kvstore_barrier_total", help="kvstore barrier calls")

TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
         "dist_sync", "dist_device_sync", "dist_async", "dist_sync_device")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._is_dist = "dist" in kv_type

    # --- identity (reference kvstore.h:223-286) ---------------------------
    @property
    def rank(self) -> int:
        return _dist.rank() if self._is_dist else 0

    @property
    def num_workers(self) -> int:
        return _dist.size() if self._is_dist else 1

    def _collective(self) -> bool:
        return self._is_dist and _dist.is_distributed()

    def barrier(self):
        """Every worker reaches this point (reference Barrier)."""
        _barrier_total.inc()
        if self._collective():
            with telemetry.span("kvstore.barrier", domain="kvstore"):
                _dist.barrier("kvstore_barrier")

    # --- data plane -------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value (reference KVStore::Init); over
        several ranks, rank 0's value."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError("duplicate init of key %r" % (k,))
            t = v._data.detach().clone()
            if self._collective() and _dist.size() > 1:
                _dist.broadcast_(t)
            self._store[k] = NDArray(t)

    def push(self, key, value, priority=0):
        """Sum each key's values and run the updater on the sum (or store
        it); one NDArray or a list (one a context) a key (reference
        KVStoreLocal::Push)."""
        del priority
        keys, grouped = _group_kv(key, value)
        nbytes = 0
        with telemetry.span("kvstore.push", domain="kvstore",
                            n_keys=len(keys)):
            for k, vals in zip(keys, grouped):
                merged = _reduce(vals)._data
                nbytes += _nbytes(merged)
                # the caller's tensor is rewritten in place later: reduce
                # or keep a copy, never the tensor itself
                own = merged is not vals[0]._data
                if self._collective():
                    if not own:
                        merged, own = merged.clone(), True
                    _dist.all_reduce_(merged)
                stored = self._store.get(k)
                if stored is None:
                    if self._updater is not None:
                        raise MXNetError(
                            "push to uninitialized key %r" % (k,))
                    self._store[k] = NDArray(merged if own
                                             else merged.clone())
                    continue
                if stored._data.device != merged.device:
                    # the stored weight moves to where the values are
                    # summed (the reference's merge buffer), so the update
                    # runs there
                    stored._data = stored._data.to(merged.device)
                if self._updater is not None:
                    self._updater(_updater_key(k), NDArray(merged), stored)
                else:
                    stored._data.copy_(merged)
        _push_total.inc(len(keys))
        _push_bytes.inc(nbytes)

    def pull(self, key, out=None, priority=0):
        """Copy the stored value into each output (reference
        KVStoreLocal::Pull, Comm::Broadcast)."""
        del priority
        keys, grouped = _group_kv(key, out)
        nbytes = 0
        with telemetry.span("kvstore.pull", domain="kvstore",
                            n_keys=len(keys)):
            for k, outs in zip(keys, grouped):
                if k not in self._store:
                    raise MXNetError("pull of uninitialized key %r" % (k,))
                src = self._store[k]._data
                for o in outs:
                    o._data.copy_(src)
                    nbytes += _nbytes(o._data)
        _pull_total.inc(len(keys))
        _pull_bytes.inc(nbytes)

    # --- updater / optimizer ---------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Install ``optimizer``'s updater; over several ranks every rank
        builds the same one and applies it alike."""
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("optimizer not set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("optimizer not set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # --- liveness (reference kvstore_dist.h:159-168) ----------------------
    def num_dead_node(self, node_id=0, timeout_sec=60):
        """Dead nodes: none (a failed rank aborts the group's
        collectives)."""
        del node_id, timeout_sec
        return 0

    def send_command_to_servers(self, head, body):
        """No server processes in the collective design."""
        del head, body


def _updater_key(k):
    if isinstance(k, (int, np.integer)):
        return int(k)
    return int(k) if isinstance(k, str) and k.isdigit() else k


def _key_value(key, value):
    if isinstance(key, (list, tuple)):
        if isinstance(value, (list, tuple)) and len(key) == len(value):
            return list(key), list(value)
        raise MXNetError("key/value length mismatch")
    return [key], [value]


def _group_kv(key, value):
    """Group duplicate keys, values in order (reference GroupKVPairs,
    kvstore_local.h:95-120)."""
    if not isinstance(key, (list, tuple)):
        key = [key]
        value = [value]
    keys: List[Any] = []
    grouped: List[List[NDArray]] = []
    pos: Dict[Any, int] = {}
    for k, v in zip(key, value):
        vals = v if isinstance(v, (list, tuple)) else [v]
        if k in pos:
            grouped[pos[k]].extend(vals)
        else:
            pos[k] = len(keys)
            keys.append(k)
            grouped.append(list(vals))
    return keys, grouped


def _reduce(vals: List[NDArray]) -> NDArray:
    """The sum of ``vals`` on the first one's device, in order (reference
    CommDevice::Reduce); one value is passed through, not copied."""
    if len(vals) == 1:
        return NDArray(vals[0]._data)
    acc = vals[0]._data
    for v in vals[1:]:
        acc = acc + v._data.to(acc.device)
    return NDArray(acc)


def _env_flag(name: str) -> bool:
    """An environment flag, parsed: "1", "true", "yes" (any case) are
    true, anything else (unset, "0", "false") false."""
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


class PSKVStore(KVStore):
    """The parameter-server store (reference KVStoreDist): weights live on
    the servers of :mod:`.kvstore_server`, push and pull are RPCs run as
    engine ops. Chosen by :func:`create` for a ``dist_*`` type when a
    server URI is configured."""

    def __init__(self, kv_type):
        super().__init__(kv_type)
        from . import engine
        from .kvstore_server import PSClient, num_workers

        self._n_workers = num_workers()
        self._rank = int(os.environ.get(
            "MXNET_TPU_WORKER_RANK", os.environ.get("DMLC_WORKER_ID", "0")))
        # rank-tagged: a sync merge keeps one contribution a rank
        self._client = PSClient(rank=self._rank)
        # one engine variable a key: a pull orders after every push of its
        # key still queued (reference kvstore_dist.h:233-241)
        self._engine = engine
        self._key_vars: Dict[Any, int] = {}
        self._rpc_errs: List[BaseException] = []
        self._errs_lock = threading.Lock()
        # liveness: hello on the control channel; "recovery" when this
        # rank's earlier connection dropped (reference kvstore_dist.h:
        # 39-42): skip the startup barriers and pull the servers' weights
        self._recovery = (self._client.hello(self._rank) == "recovery"
                          or _env_flag("MXNET_TPU_IS_RECOVERY"))
        self._hb_stop = threading.Event()
        hb = float(os.environ.get("MXNET_TPU_PS_HEARTBEAT", "2"))

        def _heartbeat_loop():
            while not self._hb_stop.wait(hb):
                try:
                    self._client.heartbeat(self._rank)
                except Exception:
                    return  # the server is gone: the next RPC raises
        if hb > 0:
            threading.Thread(target=_heartbeat_loop, daemon=True,
                             name="mxtt-ps-heartbeat").start()
        if self._rank == 0 and not self._recovery:
            # rank 0 announces the consistency mode (kvstore.cc:31-38)
            self._client.set_sync("async" not in kv_type)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._n_workers

    def _key_var(self, key):
        v = self._key_vars.get(key)
        if v is None:
            v = self._engine.new_variable()
            self._key_vars[key] = v
        return v

    def _rpc_op(self, fn, ctx):
        """An engine op running ``fn`` under the caller's trace context
        (so the client writes its traceparent on the wire); an error is
        kept for the next sync point."""
        def run():
            try:
                if ctx is not None:
                    with _trace_context.use(ctx):
                        fn()
                else:
                    fn()
            except BaseException as e:
                with self._errs_lock:
                    self._rpc_errs.append(e)
        return run

    def _raise_pending(self):
        with self._errs_lock:
            errs, self._rpc_errs = self._rpc_errs, []
        if errs:
            raise errs[0]

    def _fence(self, keys, name):
        self._engine.fence([self._key_vars[k] for k in keys
                            if k in self._key_vars], name=name).wait()
        self._raise_pending()

    def init(self, key, value):
        keys, values = _key_value(key, value)
        ctx = _trace_context.current_context()
        for k, v in zip(keys, values):
            arr = v.asnumpy()
            self._engine.push(
                self._rpc_op(lambda k=k, arr=arr: self._client.init(k, arr),
                             ctx),
                mutable_vars=[self._key_var(k)], name="ps_init")
        self.barrier()

    def push(self, key, value, priority=0):
        """Sum each key's values on the device, then queue the RPC (the
        host copy and the wire) as an engine op: the caller goes on."""
        keys, grouped = _group_kv(key, value)
        nbytes = 0
        ctx = _trace_context.current_context()
        with telemetry.span("kvstore.push", domain="kvstore",
                            n_keys=len(keys), ps=True,
                            **(ctx.stamps() if ctx is not None else {})):
            for k, vals in zip(keys, grouped):
                merged = _reduce(vals)._data
                nbytes += _nbytes(merged)
                # a copy: the executor's gradient is overwritten by the
                # next backward before the engine op reads it
                m = merged.detach().clone() if merged is vals[0]._data \
                    else merged
                self._engine.push(
                    self._rpc_op(lambda k=k, m=m: self._client.push(
                        k, _host(m)), ctx),
                    mutable_vars=[self._key_var(k)], priority=priority,
                    name="ps_push")
        _push_total.inc(len(keys))
        _push_bytes.inc(nbytes)

    def pull(self, key, out=None, priority=0):
        keys, grouped = _group_kv(key, out)
        ctx = _trace_context.current_context()
        with telemetry.span("kvstore.pull", domain="kvstore",
                            n_keys=len(keys), ps=True,
                            **(ctx.stamps() if ctx is not None else {})):
            for k, outs in zip(keys, grouped):
                shape = tuple(outs[0].shape)

                def do_pull(k=k, outs=outs, shape=shape):
                    # the element count picks the push's shard plan
                    val = self._client.pull(k, size=int(np.prod(shape)))
                    val = torch.from_numpy(np.asarray(val).reshape(shape))
                    for o in outs:
                        o._data.copy_(val)

                self._engine.push(self._rpc_op(do_pull, ctx),
                                  mutable_vars=[self._key_var(k)],
                                  priority=priority, name="ps_pull")
            # one fence over every pulled key
            self._fence(keys, "ps_pull_fence")
        # a completed pull holds the servers' weights: recovery is over
        self._recovery = False
        _pull_total.inc(len(keys))
        _pull_bytes.inc(sum(_nbytes(o._data) for outs in grouped
                            for o in outs))

    def set_optimizer(self, optimizer):
        """Rank 0 ships the optimizer to the servers (pickled without its
        symbol, which only seeded the multipliers), then all meet."""
        self._optimizer = optimizer
        if self._rank == 0 and not self._recovery:
            shipped = copy.copy(optimizer)
            shipped.sym = None
            self._client.set_optimizer(shipped)
        self.barrier()

    def num_dead_node(self, node_id=0, timeout_sec=60):
        """Workers whose control connection dropped or whose heartbeat is
        older than ``timeout_sec`` (reference GetDeadNodes); asked on the
        control channel, so it answers while a sync merge waits."""
        del node_id
        return len(self._client.dead_nodes(timeout_sec))

    def barrier(self):
        _barrier_total.inc()
        with telemetry.span("kvstore.barrier", domain="kvstore", ps=True):
            # queued RPCs first: a barrier with pushes still queued is none
            self._fence(list(self._key_vars), "ps_barrier_fence")
            if self._recovery:
                # the peers passed their startup barriers long ago
                return
            self._client.barrier()

    def finish_recovery(self):
        """Rejoin real barriers (a completed pull implies it)."""
        self._recovery = False

    def stop_server(self):
        """Drain this worker's RPCs, say goodbye and, from rank 0, stop
        the servers."""
        self._fence(list(self._key_vars), "ps_stop_fence")
        self._goodbye()
        if self._rank == 0:
            self._client.stop()
        self._client.close()

    def close(self):
        """Drain this worker's RPCs, say goodbye and drop the connections,
        leaving the servers up."""
        self._fence(list(self._key_vars), "ps_close_fence")
        self._goodbye()
        self._client.close()

    def _goodbye(self):
        """Deregister (the servers then answer a new hello of this rank as
        a fresh worker). Servers already stopped by rank 0 hold no
        registry: a closed connection then is no error."""
        self._hb_stop.set()
        try:
            self._client.goodbye(self._rank)
        except (OSError, EOFError):
            pass


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def create(name="local") -> KVStore:
    """A kvstore of type ``name`` (reference KVStore::Create): the
    parameter-server store for ``dist_*`` when ``MXNET_TPU_PS_URI`` (or
    ``DMLC_PS_ROOT_URI``) is set, else the collective one."""
    if not isinstance(name, str):
        raise TypeError("name must be string")
    if name not in TYPES:
        raise MXNetError("unknown kvstore type %r (valid: %s)"
                         % (name, TYPES))
    if "dist" in name and (os.environ.get("MXNET_TPU_PS_URI")
                           or os.environ.get("DMLC_PS_ROOT_URI")):
        return PSKVStore(name)
    return KVStore(name)

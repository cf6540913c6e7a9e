"""The parameter server's recovery check: a worker dies and rejoins.

Counterpart of ``tests/nightly/dist_recovery_kvstore.py``, on the port.
Each of the sync workers pushes (rank + 1) times ones a round under the
Test optimizer, so after round r the value is r * sum(rank + 1). The
victim (``MXNET_TPU_VICTIM_RANK``) exits 42 after round
``MXNET_TPU_KILL_AFTER_ROUND``; the survivors, whose next merge waits,
see ``num_dead_node() == 1`` on the control channel and print
``SAW_DEAD=1``; the victim started again is answered "recovery" (its
earlier connection dropped), skips the startup barrier, reads the round
it stands at from the servers' weights and finishes; every worker ends
on the closed form exactly, with no dead node left, at a real barrier.

    python -m mxnet_tpu_torch.tools.dist_recovery_kvstore   # by role

Prints one JSON line a worker.
"""
from __future__ import annotations

import argparse
import json
import os
import time

KEY = 3
SHAPE = (4, 4)
ROUNDS = 6


def worker(device):
    import numpy as np

    import mxnet_tpu_torch as mt

    rank = int(os.environ["MXNET_TPU_WORKER_RANK"])
    n = int(os.environ["MXNET_TPU_NUM_WORKERS"])
    victim = int(os.environ.get("MXNET_TPU_VICTIM_RANK", "-1"))
    kill_after = int(os.environ.get("MXNET_TPU_KILL_AFTER_ROUND", "0"))
    scale = sum(r + 1 for r in range(n))

    kv = mt.kvstore.create("dist_sync")
    recovering = kv._recovery
    if recovering:
        print("worker %d REJOINED as recovery" % rank, flush=True)
    # before any pull: a pull ends the recovery, and set_optimizer's
    # barrier must still be skipped while the peers are mid-run
    kv.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
    kv.init(KEY, mt.nd.zeros(SHAPE, device))  # the first init wins

    out = mt.nd.zeros(SHAPE, device)
    kv.pull(KEY, out=out)
    done = int(round(float(out.asnumpy().flat[0]) / scale))
    if recovering:
        assert done == kill_after, (done, kill_after)
        assert not kv._recovery, "a pull ends the recovery"
    else:
        assert done == 0, done
    saw_dead = False
    for rnd in range(done + 1, ROUNDS + 1):
        kv.push(KEY, mt.nd.ones(SHAPE, device) * (rank + 1))
        if rank == victim and not recovering and rnd == kill_after:
            # the pull waits for the round's merge: the exit lands on a
            # round's end, no part of the next one pushed
            kv.pull(KEY, out=out)
            assert float(out.asnumpy().flat[0]) == rnd * scale
            print("worker %d dying after round %d" % (rank, rnd),
                  flush=True)
            os._exit(42)
        if rank != victim and victim >= 0 and rnd == kill_after + 1:
            deadline = time.time() + 60
            while kv.num_dead_node(timeout_sec=30) != 1:
                assert time.time() < deadline, "never saw the dead worker"
                time.sleep(0.1)
            saw_dead = True
            print("worker %d SAW_DEAD=1" % rank, flush=True)
    kv.pull(KEY, out=out)
    want = np.full(SHAPE, float(ROUNDS * scale), np.float32)
    assert np.array_equal(out.asnumpy(), want), (out.asnumpy().flat[:4],
                                                 want.flat[:4])
    deadline = time.time() + 60
    while kv.num_dead_node(timeout_sec=30) != 0:
        assert time.time() < deadline, "the dead count stayed above 0"
        time.sleep(0.1)
    kv.barrier()  # every worker, the recovered one too
    kv.stop_server() if rank == 0 else kv.close()
    return {"rank": rank, "recovered": recovering, "saw_dead": saw_dead,
            "rounds": ROUNDS, "value": float(out.asnumpy().flat[0]),
            "ok": True}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    from mxnet_tpu_torch import kvstore_server

    if kvstore_server.maybe_run_server_by_role():
        return 0
    print(json.dumps(worker(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

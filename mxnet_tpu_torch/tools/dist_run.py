"""Start a group of processes for the distributed paths, and stop it.

Used by ``chip_smoke.py`` (its ``dist`` phase) and the CPU tests of the
multi-process paths; a script that trains through ``dist_*`` runs under
``tools/launch.py`` as well. Two shapes of group:

- **collective**: ``n`` workers with ``MXNET_TPU_COORDINATOR`` a
  ``file://`` rendezvous in the group's directory (no port to race for),
  ``MXNET_TPU_NUM_PROCS`` and ``MXNET_TPU_PROC_ID`` (what
  ``parallel.dist.init`` reads);
- **parameter server**: ``n_servers`` servers, each started on port 0
  (``MXNET_TPU_PS_URI=127.0.0.1:0``) and writing the port it bound to
  ``MXNET_TPU_PS_PORT_FILE``, then ``n`` workers with the servers'
  addresses, ``MXNET_TPU_NUM_WORKERS`` and ``MXNET_TPU_WORKER_RANK``.

Each process writes its standard output and errors to a file in the
group's directory. :meth:`Group.wait` fails when a worker exits non-zero
or outlives the deadline; :meth:`Group.stop` kills whatever still runs
(call it in ``finally``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


class GroupFailed(RuntimeError):
    pass


class Group:
    def __init__(self, workdir, env=None):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.env = dict(os.environ if env is None else env)
        # the children import this checkout's package
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in self.env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.servers = []
        self.workers = {}
        self.uri = None
        #: name -> wall-clock time (time.time()) it was started
        self.spawned_at = {}

    def _spawn(self, cmd, env, name):
        self.spawned_at[name] = time.time()
        out = open(os.path.join(self.workdir, name + ".log"), "w")
        try:
            return subprocess.Popen(cmd, env=env, stdout=out,
                                    stderr=subprocess.STDOUT, text=True)
        finally:
            out.close()

    def log(self, name):
        """The output of process ``name`` ("server0", "worker1", ...)."""
        path = os.path.join(self.workdir, name + ".log")
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    def start_servers(self, cmd, n_servers, n_workers, timeout_s=60.0,
                      wait=True):
        """Start ``n_servers`` servers of ``cmd`` on free ports; with
        ``wait``, return their URI list once every one has bound (else
        :meth:`servers_bound` does)."""
        for sid in range(n_servers):
            env = dict(self.env, MXNET_TPU_ROLE="server",
                       MXNET_TPU_SERVER_ID=str(sid),
                       MXNET_TPU_PS_URI="127.0.0.1:0",
                       MXNET_TPU_PS_PORT_FILE=self._port_file(sid),
                       MXNET_TPU_NUM_WORKERS=str(n_workers))
            self.servers.append(self._spawn(cmd, env, "server%d" % sid))
        return self.servers_bound(timeout_s) if wait else None

    def _port_file(self, sid):
        return os.path.join(self.workdir, "server%d.port" % sid)

    def servers_bound(self, timeout_s=60.0):
        """The servers' URI list, once every one has written its port."""
        files = [self._port_file(sid) for sid in range(len(self.servers))]
        self.wait_files(files, timeout_s, self.servers, "server")
        addrs = []
        for f in files:
            with open(f) as fh:
                addrs.append(fh.read().strip())
        self.uri = ",".join(addrs)
        return self.uri

    def wait_files(self, paths, timeout_s, procs=None, what="worker"):
        """Wait until every path exists; fails if one of ``procs`` (the
        workers) exits first or the deadline passes."""
        procs = list(self.workers.values()) if procs is None else procs
        deadline = time.time() + timeout_s
        while not all(os.path.exists(f) for f in paths):
            for i, p in enumerate(procs):
                if p.poll() is not None:
                    raise GroupFailed("%s %d exited %s early:\n%s"
                                      % (what, i, p.returncode,
                                         self.log("%s%d" % (what, i))
                                         [-3000:]))
            if time.time() > deadline:
                raise GroupFailed("%s missing after %.0f s"
                                  % ([f for f in paths
                                      if not os.path.exists(f)], timeout_s))
            time.sleep(0.02)

    def start_worker(self, cmd, rank, n):
        """Start worker ``rank`` of ``n``: of the parameter server when
        servers run, else of a collective group."""
        env = dict(self.env)
        if self.uri is not None:
            env.update(MXNET_TPU_ROLE="worker", MXNET_TPU_PS_URI=self.uri,
                       MXNET_TPU_NUM_WORKERS=str(n),
                       MXNET_TPU_WORKER_RANK=str(rank))
        else:
            env.update(MXNET_TPU_COORDINATOR="file://" + os.path.join(
                self.workdir, "rendezvous"),
                MXNET_TPU_NUM_PROCS=str(n), MXNET_TPU_PROC_ID=str(rank))
        name = "worker%d" % rank
        if rank in self.workers:  # a restart: keep the first log
            name += "-restart"
        self.workers[rank] = self._spawn(cmd, env, name)
        return self.workers[rank]

    def start_workers(self, cmd, n):
        for rank in range(n):
            self.start_worker(cmd, rank, n)

    def wait(self, timeout_s, ranks=None, expect_rc=0):
        """Wait for the workers ``ranks`` (all) to exit ``expect_rc``;
        returns {rank: output}. A worker that exits otherwise, or runs past
        the deadline, fails the group at once."""
        deadline = time.time() + timeout_s
        pending = dict((r, self.workers[r]) for r in
                       (self.workers if ranks is None else ranks))
        outs = {}
        while pending:
            for r, p in list(pending.items()):
                if p.poll() is None:
                    continue
                name = "worker%d" % r
                if os.path.exists(os.path.join(self.workdir,
                                               name + "-restart.log")):
                    name += "-restart"
                out = self.log(name)
                if p.returncode != expect_rc:
                    raise GroupFailed("worker %d exited %s (want %s):\n%s"
                                      % (r, p.returncode, expect_rc,
                                         out[-4000:]))
                outs[r] = out
                del pending[r]
            if pending and time.time() > deadline:
                raise GroupFailed(
                    "workers %s still running after %.0f s:\n%s"
                    % (sorted(pending), timeout_s,
                       "\n".join(self.log("worker%d" % r)[-1500:]
                                 for r in sorted(pending))))
            time.sleep(0.05)
        return outs

    def wait_servers(self, timeout_s):
        """Wait for the servers to exit 0 (a worker sent stop)."""
        deadline = time.time() + timeout_s
        for sid, p in enumerate(self.servers):
            try:
                p.wait(max(deadline - time.time(), 0.01))
            except subprocess.TimeoutExpired:
                raise GroupFailed("server %d still running after %.0f s"
                                  % (sid, timeout_s))
            if p.returncode != 0:
                raise GroupFailed("server %d exited %s:\n%s"
                                  % (sid, p.returncode,
                                     self.log("server%d" % sid)[-3000:]))

    def stop(self):
        """Kill every process still running and reap them all."""
        procs = list(self.workers.values()) + self.servers
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                pass


def last_json(out):
    """The last line of ``out`` that parses as a JSON object."""
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    raise GroupFailed("no JSON line in:\n%s" % out[-3000:])


def module_cmd(module, *args):
    """``python -m module args`` with this interpreter."""
    return [sys.executable, "-m", module] + [str(a) for a in args]

"""Multi-node launcher front-end, one process per card (port of
``deepspeed_tpu/launcher/runner.py``, itself the reference's
``deepspeed/launcher/runner.py:254-330``).

Reads a hostfile, applies ``--include``/``--exclude`` node/slot filters,
encodes the resource map, and either execs the per-node spawner directly
(single node) or fans out over pdsh/ssh/OpenMPI/MVAPICH (multi node).
Each slot is one process and one card: the spawner exports the slot as
``LOCAL_RANK`` (and ``DS_LOCAL_RANK``), which
``utils/distributed.get_local_rank`` reads, so a filtered hostfile's
slots 1 and 3 bind ``cuda:1`` and ``cuda:3``.  The per-process
rendezvous (``DS_COORDINATOR``/``DS_NUM_PROCESSES``/``DS_PROCESS_ID``)
is what ``utils/distributed.init_distributed`` hands to
``torch.distributed.init_process_group``.  With no hostfile the runner
counts the local cards once; with none and no ``--num_procs`` it raises
(it never falls back to a CPU process).

Usage::

    python -m deepspeed_tpu_torch.launcher.runner [--hostfile H]
        [--include w1@w2:0,1] [--num_nodes N] [--num_procs P]
        your_script.py --your-args

Stdlib-only, as in the JAX package.
"""

import argparse
import base64
import json
import logging
import os
import re
import shlex
import subprocess
import sys

from .constants import (DEFAULT_HOSTFILE, DEFAULT_MASTER_PORT,
                        ENV_COORDINATOR, ENV_NUM_PROCESSES, MVAPICH_LAUNCHER,
                        OPENMPI_LAUNCHER, PDSH_LAUNCHER, SSH_LAUNCHER)

logger = logging.getLogger(__name__)

#: env-var name prefixes forwarded to every worker process (reference
#: ``runner.py:27`` exports NCCL/PYTHON/MV2/UCX; the JAX package's
#: JAX/XLA/LIBTPU/TPU give way to the CUDA stack's NCCL/CUDA/TORCH, and
#: the framework's own DS_* feature toggles must reach workers too)
EXPORT_ENVS = ("NCCL", "CUDA", "TORCH", "PYTHON", "MV2", "UCX", "DS_")
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
DEEPSPEED_ENVIRONMENT_PATHS = (os.path.expanduser("~"), ".")

#: per-process rendezvous vars the spawners own — forwarding a stale copy
#: from the launcher's shell would make every rank claim the same id (the
#: MPI path has no per-child override, unlike launch.py); torchrun's
#: names too, which a shell that ran torchrun before may still hold
_NO_FORWARD = frozenset(("DS_COORDINATOR", "DS_NUM_PROCESSES",
                         "DS_PROCESS_ID", "DS_LOCAL_RANK", "RANK",
                         "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT"))

_ENV_KEY_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def collect_exports(environ=None, paths=DEEPSPEED_ENVIRONMENT_PATHS):
    """Env vars that must travel to worker processes: every var whose name
    starts with an ``EXPORT_ENVS`` prefix, then ``KEY=VALUE`` lines from
    ``.deepspeed_env`` files (reference ``runner.py:341-356``; file entries
    override inherited env, later files override earlier ones)."""
    environ = os.environ if environ is None else environ
    exports = {}
    for k, v in environ.items():
        if not any(k.startswith(p) for p in EXPORT_ENVS) or k in _NO_FORWARD:
            continue
        # names with shell-illegal chars (legal in the process environment)
        # would break the remote `export` silently — skip them loudly
        if not _ENV_KEY_RE.match(k):
            logger.warning(f"not forwarding env var {k!r}: name is not a "
                           "shell identifier")
            continue
        exports[k] = v
    for d in paths:
        path = os.path.join(d, DEEPSPEED_ENVIRONMENT_NAME)
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                key, sep, val = line.partition("=")
                key = key.strip()
                # fail at parse time, not as a shell error on remote hosts
                if not sep or not _ENV_KEY_RE.match(key):
                    raise ValueError(
                        f"malformed line in {path}: {line!r} "
                        "(expected SHELL_IDENTIFIER=value)")
                if key not in _NO_FORWARD:
                    exports[key] = val.strip()
    return exports


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed-TPU PyTorch port launcher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-H", "--hostfile", type=str, default=DEFAULT_HOSTFILE,
                        help="hostfile of 'hostname slots=N' lines")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="nodes/slots to include, e.g. "
                             "'worker-0@worker-1:0,2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="nodes/slots to exclude, e.g. 'worker-1:0'")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="cap on node count (first N of the hostfile)")
    parser.add_argument("--num_procs", type=int, default=-1,
                        help="processes per node (default: hostfile slots, "
                             "or one per visible card)")
    parser.add_argument("--master_addr", type=str, default="",
                        help="coordinator address (default: first node)")
    parser.add_argument("--master_port", type=int, default=DEFAULT_MASTER_PORT)
    parser.add_argument("--launcher", type=str, default=PDSH_LAUNCHER,
                        choices=[PDSH_LAUNCHER, SSH_LAUNCHER,
                                 OPENMPI_LAUNCHER, MVAPICH_LAUNCHER])
    parser.add_argument("--force_multi", action="store_true",
                        help="treat as multi-node even for one host")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args)


def fetch_hostfile(path):
    """Parse 'hostname slots=N' lines (reference ``runner.py:115-143``).
    Returns an ordered {hostname: slots} dict; {} when the file is absent
    (single-node fallback)."""
    if not os.path.isfile(path):
        return {}
    pool = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            try:
                host, slots = line.split()
                key, n = slots.split("=")
                assert key == "slots"
                n = int(n)
            except Exception as e:
                raise ValueError(f"malformed hostfile line: {line!r}") from e
            if host in pool:
                raise ValueError(f"duplicate host {host!r} in hostfile")
            pool[host] = n
    return pool


def _parse_filter(spec):
    """'w0@w1:0,2' -> {'w0': None, 'w1': [0, 2]} (None = every slot)."""
    out = {}
    for part in spec.split("@"):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.split(":")
            out[host.strip()] = sorted(int(s) for s in slots.split(","))
        else:
            out[part] = None
    return out


def filter_resources(pool, include="", exclude=""):
    """Apply include/exclude filters (reference ``runner.py:146-245``).
    Returns ordered {host: [slot ids]}."""
    assert not (include and exclude), "--include and --exclude are exclusive"
    active = {h: list(range(n)) for h, n in pool.items()}
    if include:
        spec = _parse_filter(include)
        unknown = set(spec) - set(active)
        assert not unknown, f"include references unknown hosts {sorted(unknown)}"
        active = {h: (spec[h] if spec[h] is not None else active[h])
                  for h in active if h in spec}
        for h, slots in active.items():
            bad = set(slots) - set(range(pool[h]))
            assert not bad, f"include slots {sorted(bad)} out of range on {h}"
    elif exclude:
        spec = _parse_filter(exclude)
        unknown = set(spec) - set(active)
        assert not unknown, f"exclude references unknown hosts {sorted(unknown)}"
        for h, slots in spec.items():
            if slots is None:
                active.pop(h, None)
            else:
                bad = set(slots) - set(range(pool[h]))
                assert not bad, f"exclude slots {sorted(bad)} out of range on {h}"
                active[h] = [s for s in active[h] if s not in slots]
                if not active[h]:
                    active.pop(h)
    return active


def encode_world_info(active):
    return base64.urlsafe_b64encode(
        json.dumps(active).encode()).decode()


def decode_world_info(encoded):
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


def build_launch_cmd(args, active, node_rank, master_addr):
    """The per-node spawner command (runs on each host)."""
    return [
        sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
        f"--world_info={encode_world_info(active)}",
        f"--node_rank={node_rank}",
        f"--master_addr={master_addr}",
        f"--master_port={args.master_port}",
        "--", args.user_script, *args.user_args,
    ]


class MultiNodeRunner:
    """Base for remote fan-out backends (reference
    ``multinode_runner.py:47-75``)."""

    def __init__(self, args, active, master_addr, exports=None):
        self.args = args
        self.active = active
        self.master_addr = master_addr
        self.user_exports = dict(exports or {})

    def export_prefix(self):
        """``export K=V; `` prelude for ssh/pdsh remote shells (reference
        ``multinode_runner.py:57-62``)."""
        return "".join(f"export {k}={shlex.quote(v)}; "
                       for k, v in self.user_exports.items())

    def commands(self):
        raise NotImplementedError


class PDSHRunner(MultiNodeRunner):
    name = PDSH_LAUNCHER

    def commands(self):
        hosts = ",".join(self.active.keys())
        # pdsh broadcasts one identical command line; each node passes
        # node_rank=auto and the spawner resolves its rank by matching its
        # hostname against the world info
        cmd = build_launch_cmd(self.args, self.active, "auto", self.master_addr)
        return [["pdsh", "-S", "-f", "1024", "-w", hosts,
                 "{}cd {}; {}".format(self.export_prefix(),
                                      shlex.quote(os.getcwd()),
                                      " ".join(shlex.quote(c) for c in cmd))]]


class SSHRunner(MultiNodeRunner):
    name = SSH_LAUNCHER

    def commands(self):
        cmds = []
        for rank, host in enumerate(self.active):
            cmd = build_launch_cmd(self.args, self.active, rank,
                                   self.master_addr)
            cmds.append(["ssh", host,
                         "{}cd {}; {}".format(
                             self.export_prefix(),
                             shlex.quote(os.getcwd()),
                             " ".join(shlex.quote(c) for c in cmd))])
        return cmds


class MPIRunnerBase(MultiNodeRunner):
    """MPI-scheduled transports (reference ``multinode_runner.py:77-190``).

    Unlike pdsh/ssh, mpirun launches every RANK directly (no per-node
    spawner): the user script runs once per process and
    ``utils/distributed.init_distributed`` resolves its process id/count
    from the MPI environment (``OMPI_COMM_WORLD_RANK`` / ``MV2_COMM_WORLD_
    RANK``) while the coordinator address rides an exported ``DS_*`` var.
    """

    #: env exported to every rank ({} overridden per backend)
    exports = {}

    def __init__(self, args, active, master_addr, exports=None):
        super().__init__(args, active, master_addr, exports)
        self._tmp_files = []
        assert not (args.include or args.exclude), (
            f"{self.name} backend does not support worker include/exclusion "
            "(mpirun owns placement via the hostfile)")

    def backend_exists(self):
        raise NotImplementedError

    def rank_env(self):
        total = sum(len(s) for s in self.active.values())
        # backend defaults < user/.deepspeed_env exports < rendezvous contract
        return {
            **self.exports,
            **self.user_exports,
            ENV_COORDINATOR: f"{self.master_addr}:{self.args.master_port}",
            ENV_NUM_PROCESSES: str(total),
        }

    def _write_hostfile(self, line_fn):
        """A per-invocation hostfile derived from the FILTERED resource set
        (``--num_nodes``/``--num_procs`` trims and the no-hostfile hostname
        fallback must reach mpirun, so the user's raw hostfile path can't be
        passed through).  A mkstemp path, not a fixed /tmp name: concurrent
        launches on one login host must not clobber each other's placement,
        and a fixed world-writable path is a symlink hazard."""
        import tempfile

        fd, path = tempfile.mkstemp(prefix="deepspeed_mpi_hostfile_",
                                    suffix=".txt", text=True)
        with os.fdopen(fd, "w") as f:
            for host, slots in self.active.items():
                f.write(line_fn(host, len(slots)) + "\n")
        self._tmp_files.append(path)
        return path

    def cleanup(self):
        for path in self._tmp_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._tmp_files = []


class OpenMPIRunner(MPIRunnerBase):
    name = OPENMPI_LAUNCHER
    exports = {"UCX_TLS": "tcp"}

    def backend_exists(self):
        import shutil

        return shutil.which("ompi_info") is not None

    def commands(self):
        total = sum(len(s) for s in self.active.values())
        hostfile = self._write_hostfile(lambda h, n: f"{h} slots={n}")
        cmd = ["mpirun", "-n", str(total), "-hostfile", hostfile,
               "--mca", "btl", "^openib"]
        for k, v in self.rank_env().items():
            cmd += ["-x", f"{k}={v}"]
        cmd += [sys.executable, "-u", self.args.user_script,
                *self.args.user_args]
        return [cmd]


class MVAPICHRunner(MPIRunnerBase):
    name = MVAPICH_LAUNCHER
    # the JAX package's MVAPICH defaults, kept so both launch alike
    exports = {"MV2_SMP_USE_CMA": "0", "MV2_DEBUG_SHOW_BACKTRACE": "1"}

    def backend_exists(self):
        import shutil

        return shutil.which("mpiname") is not None

    def commands(self):
        counts = [len(s) for s in self.active.values()]
        total = sum(counts)
        assert all(c == counts[0] for c in counts), (
            "mvapich requires the same process count on every node")
        hostfile = self._write_hostfile(lambda h, n: h)
        cmd = ["mpirun", "-np", str(total), "-ppn", str(counts[0]),
               "--hostfile", hostfile]
        for k, v in self.rank_env().items():
            # Hydra's -env consumes TWO tokens: name, value
            cmd += ["-env", k, v]
        cmd += [sys.executable, "-u", self.args.user_script,
                *self.args.user_args]
        return [cmd]


_RUNNERS = {PDSH_LAUNCHER: PDSHRunner, SSH_LAUNCHER: SSHRunner,
            OPENMPI_LAUNCHER: OpenMPIRunner, MVAPICH_LAUNCHER: MVAPICHRunner}


def local_card_count():
    """The cards this host can see, counted once (the one place the
    launcher touches torch; counting does not create a CUDA context)."""
    import torch

    return torch.cuda.device_count()


def main(argv=None):
    args = parse_args(argv)
    pool = fetch_hostfile(args.hostfile)
    if not pool:
        assert not (args.include or args.exclude), (
            f"no hostfile at {args.hostfile}; include/exclude need one")
        import socket

        nprocs = args.num_procs
        if nprocs <= 0:
            nprocs = local_card_count()
            if nprocs <= 0:
                raise RuntimeError(
                    "no CUDA card visible and no --num_procs: the launcher "
                    "runs one process per card and never falls back to a "
                    "CPU process; pass --num_procs N for CPU ranks")
        pool = {socket.gethostname(): nprocs}
    if args.num_nodes > 0:
        pool = dict(list(pool.items())[:args.num_nodes])
    if args.num_procs > 0:
        pool = {h: args.num_procs for h in pool}
    active = filter_resources(pool, args.include, args.exclude)
    assert active, "no hosts left after include/exclude filtering"
    master_addr = args.master_addr or next(iter(active))
    logger.info(f"launching on {active} (coordinator {master_addr}:"
                f"{args.master_port})")

    exports = collect_exports()
    if (len(active) == 1 and not args.force_multi
            and args.launcher in (PDSH_LAUNCHER, SSH_LAUNCHER)):
        cmd = build_launch_cmd(args, active, 0, master_addr)
        # local spawns inherit the env already; merging applies any
        # .deepspeed_env file entries so both paths see the same contract
        result = subprocess.call(cmd, env={**os.environ, **exports})
        sys.exit(result)

    runner = _RUNNERS[args.launcher](args, active, master_addr, exports)
    if isinstance(runner, MPIRunnerBase) and not runner.backend_exists():
        raise RuntimeError(
            f"--launcher={args.launcher} requested but its mpirun toolchain "
            "was not found on PATH")
    try:
        procs = [subprocess.Popen(c) for c in runner.commands()]
        rc = 0
        for p in procs:
            p.wait()
            rc = rc or p.returncode
    finally:
        # temp hostfiles must not leak on Ctrl-C / launch failure either
        if hasattr(runner, "cleanup"):
            runner.cleanup()
    sys.exit(rc)


if __name__ == "__main__":
    main()

"""Run a command on every host of the hostfile (port of
``deepspeed_tpu/launcher/ds_ssh.py``, the reference's ``bin/ds_ssh``):
``python -m deepspeed_tpu_torch.launcher.ds_ssh [-H hostfile] cmd ...``."""
import argparse
import shlex
import subprocess
import sys

from deepspeed_tpu_torch.launcher.constants import DEFAULT_HOSTFILE
from deepspeed_tpu_torch.launcher.runner import fetch_hostfile


def main(argv=None):
    parser = argparse.ArgumentParser(description="run a command on all hosts")
    parser.add_argument("-H", "--hostfile", default=DEFAULT_HOSTFILE)
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    assert args.command, "no command given"
    # one quoted command line, identical semantics locally and over ssh
    line = " ".join(shlex.quote(c) for c in args.command)
    pool = fetch_hostfile(args.hostfile) or {"localhost": 1}
    rc = 0
    for host in pool:
        print(f"----- {host} -----")
        if host == "localhost":
            proc = subprocess.run(line, shell=True)
        else:
            proc = subprocess.run(["ssh", host, line])
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()

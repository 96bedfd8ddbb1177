"""Launcher constants (port of ``deepspeed_tpu/launcher/constants.py``).

The ``DS_*`` names are the JAX launcher's, so a child spawned by either
launcher reads the same contract.  One thing differs: the JAX launcher
runs one process that drives every local chip (its
``DEFAULT_PROCS_PER_NODE = 1``), the port runs one process per visible
card (the original DeepSpeed runner's rule), so there is no fixed
default process count: with no hostfile the runner counts the cards
(``runner.local_card_count``)."""

PDSH_LAUNCHER = "pdsh"
SSH_LAUNCHER = "ssh"
OPENMPI_LAUNCHER = "openmpi"
MVAPICH_LAUNCHER = "mvapich"

DEFAULT_HOSTFILE = "/job/hostfile"
DEFAULT_MASTER_PORT = 29500

# env contract consumed by utils/distributed.init_distributed
ENV_COORDINATOR = "DS_COORDINATOR"
ENV_NUM_PROCESSES = "DS_NUM_PROCESSES"
ENV_PROCESS_ID = "DS_PROCESS_ID"
ENV_LOCAL_RANK = "DS_LOCAL_RANK"
# torchrun's name for the slot, exported beside DS_LOCAL_RANK so that
# code written for torchrun binds cuda:<slot> too
ENV_TORCH_LOCAL_RANK = "LOCAL_RANK"

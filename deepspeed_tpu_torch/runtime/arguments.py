"""CLI argument helpers (port of ``deepspeed_tpu/runtime/arguments.py``,
the reference's ``deepspeed/__init__.py:142-207``)."""


def _add_core_arguments(parser):
    """Core DeepSpeed arguments shared by all scripts (reference ``:142-190``)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no impact on "
                            "DeepSpeed backend)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable DeepSpeed (helper flag for user code, no "
                            "impact on DeepSpeed backend)")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated DeepSpeed json configuration file.")
    return parser


def add_config_arguments(parser):
    """Update the argument parser to enable the DeepSpeed config args
    (reference ``deepspeed/__init__.py:193-207``)."""
    parser = _add_core_arguments(parser)
    return parser

"""Utilities of the port: profiling, debug validation, and PNG encode and
decode without Pillow (`utils.png`)."""

from tpurt_torch.utils.debug import nan_report, validate_scene, with_checks
from tpurt_torch.utils.profiling import KernelTimer, annotate, trace

__all__ = [
    "nan_report",
    "validate_scene",
    "with_checks",
    "KernelTimer",
    "annotate",
    "trace",
]

from cudasbmp_jax.utils.profiling import Timer, trace_to, phase_scope
from cudasbmp_jax.utils.metrics import iteration_metrics_table, summarize_result

__all__ = [
    "Timer",
    "trace_to",
    "phase_scope",
    "iteration_metrics_table",
    "summarize_result",
]

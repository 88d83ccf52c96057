from .executor import Executor, RunConfig, TraceContext  # noqa: F401

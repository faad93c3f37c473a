"""Host ms a train step in the program's ``m2t::augment`` span (the draws,
the staging), less the ``m2t::wait`` spans inside it (waiting for the
device); ``train.loop``, ``utils.staging``."""

from h100bench.core.readers import step_host_ms as read  # noqa: F401

"""The segment service and its continuous batcher, the model-zoo backend,
its client and the browser GUI."""

from .post_process import PROCESS_TOOLBOX  # noqa: F401

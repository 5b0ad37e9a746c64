"""The port's configuration: ``NVSFConfig`` (with ``finalize()``) of
``nvsf_tpu/config.py``, a JAX-free dataclass of the training flags, exposed
here so that code driving the port imports it from ``nvsf_torch`` alone."""

from nvsf_tpu.config import NVSFConfig

__all__ = ["NVSFConfig"]

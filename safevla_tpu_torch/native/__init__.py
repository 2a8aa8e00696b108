"""Native host code of the port: the shared-memory observation ring."""

from safevla_tpu_torch.native.obs_ring import ObsRing, build_native, native_available

__all__ = ["ObsRing", "build_native", "native_available"]

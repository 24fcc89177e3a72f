"""Platform facts and the one platform check of the hot paths.

The reference gates on CUDA device properties (>=1024 threads/block, >32KB
shared memory, grid dims; src/ulvt/utils/common.cu:6-43).  Here the checks
are: which backend JAX runs on, how many devices it has, and how much device
memory a process may use.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DeviceCapabilities", "check_capabilities", "check_platform",
           "device_memory_limit", "PLATFORMS"]

# Backends the hot paths were measured on.  Every op runs its plain jnp
# program on both: the hand-written kernels tried for the card did not
# compile in a usable time (PERF.md).
PLATFORMS = ("cpu", "gpu")


def check_platform(platform: str | None = None) -> str:
    """Return `platform` (default: JAX's backend) if the hot paths run
    there; any other platform raises, so no path silently stands in for a
    device the code was not measured on."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {platform!r}; measured on {PLATFORMS}")
    return platform


def device_memory_limit(device=None) -> int | None:
    """Bytes one process may allocate on `device` (default: the first),
    from the runtime's ``memory_stats()``; None where the backend does not
    report it (the CPU)."""
    import jax

    d = jax.devices()[0] if device is None else device
    stats = d.memory_stats()
    if not stats:
        return None
    return stats.get("bytes_limit")


@dataclass
class DeviceCapabilities:
    platform: str
    device_kind: str
    num_devices: int
    memory_bytes: int | None

    @property
    def is_accelerator(self) -> bool:
        return self.platform not in ("cpu",)


def check_capabilities(min_devices: int = 1) -> DeviceCapabilities:
    """Raise if no backend with `min_devices` devices is available."""
    import jax

    devs = jax.devices()
    if len(devs) < min_devices:
        raise RuntimeError(
            f"need >= {min_devices} devices, found {len(devs)}")
    d = devs[0]
    return DeviceCapabilities(
        platform=d.platform,
        device_kind=getattr(d, "device_kind", "unknown"),
        num_devices=len(devs),
        memory_bytes=device_memory_limit(d),
    )

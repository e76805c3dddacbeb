"""The accelerator a measurement runs on: a hard check and a stamp.

Every timing this project reports names its device. A measurement path
that finds no GPU stops; it never falls back to the CPU.
"""

import subprocess


def require_gpu():
    """Return ``jax.devices()`` when JAX's default backend is a GPU;
    raise ``SystemExit`` (non-zero) otherwise."""
    import jax

    backend = jax.default_backend()
    devs = jax.devices()
    if backend != "gpu" or devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {backend!r} "
            f"({devs[0].platform}, {devs[0].device_kind})"
        )
    return devs


def nvidia_smi_name_power():
    """One line per card: ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_stamp(devs):
    """Platform, device kind, count and card power limit, for a result."""
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "nvidia_smi": nvidia_smi_name_power(),
    }

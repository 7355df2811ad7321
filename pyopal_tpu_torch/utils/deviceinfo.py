"""Backend/device introspection — the `_cpu_info` analog.

Port of ``pyopal_tpu/utils/deviceinfo.py``.  Upstream PyOpal exposes
build/runtime SIMD capability flags (``src/pyopal/lib.pyx:133-148``);
here the equivalents are the backend (``cuda`` or ``cpu``), the cards
PyTorch sees, the CUDA kernels and their build state, and whether the C
codec is active.
"""

from __future__ import annotations


def _device_info():
    """Return information about the runtime accelerator environment.

    On a host without CUDA the backend is ``"cpu"`` and there are no
    devices; it never raises for lack of a card.
    """
    import torch

    from .. import alphabet
    from ..ops import _cuda, ragged

    cuda = torch.cuda.is_available()
    devices = []
    for i in range(torch.cuda.device_count() if cuda else 0):
        p = torch.cuda.get_device_properties(i)
        devices.append({
            "id": i,
            "kind": p.name,
            "capability": f"{p.major}.{p.minor}",
            "sm_count": p.multi_processor_count,
            "memory_bytes": p.total_memory,
        })
    return {
        "backend": "cuda" if cuda else "cpu",
        "devices": devices,
        "n_devices": len(devices),
        "engines": {
            "cuda": {
                "available": cuda,
                # each kernel's library: built from these sources (on
                # disk) and the seconds its build took in this process
                "kernels": {
                    name: {
                        "built": _cuda._library_path(name).exists(),
                        "build_seconds": _cuda.build_seconds.get(name),
                    }
                    for name in _cuda.KERNELS
                },
                # what the dispatcher routes: K1/K5 up to this tier, the
                # segmented long-query kernel (K3, unbounded) beyond it
                "max_query_len": ragged.RAGGED_MAX_QPAD_STRIP,
                "long_queries": "segmented (unbounded)",
            },
            "plain": {"available": True},
            "native_encoder": {
                "available": alphabet._native_encoder is not None
            },
        },
    }

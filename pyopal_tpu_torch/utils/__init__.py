"""Runtime introspection and measurement helpers (port of
``pyopal_tpu/utils``).

- `deviceinfo._device_info`: the backend, its cards and which engines
  the searches use (exported as ``pyopal_tpu_torch._device_info``);
- `profiling`: GCUPS accounting, the packed layout's padding, a
  wall-clock `Timer` and a `torch.profiler` trace.

The reference's ``utils/cache.py`` turns on JAX's persistent compile
cache; it has no counterpart here, because `pyopal_tpu_torch.ops._cuda`
and `pyopal_tpu_torch.native` already keep what they compile, named by
a hash of its sources, and reuse it across processes.
"""

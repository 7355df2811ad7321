"""Build script for the native extension (C sequence codec).

Build in place with::

    python setup.py build_ext --inplace

The package works without the extension (pure-numpy fallbacks); the
extension accelerates host-side encoding, FASTA parsing, and block
packing for large databases.
"""

from setuptools import Extension, setup

setup(
    name="pyopal-tpu",
    version="0.5.1",
    packages=[
        "pyopal_tpu",
        "pyopal_tpu.models",
        "pyopal_tpu.ops",
        "pyopal_tpu.parallel",
        "pyopal_tpu.utils",
        "pyopal_tpu.native",
        "pyopal_tpu.tests",
        "pyopal_tpu_torch",
        "pyopal_tpu_torch.models",
        "pyopal_tpu_torch.ops",
        "pyopal_tpu_torch.parallel",
    ],
    package_data={"pyopal_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "pyopal_tpu.native._encoder",
            sources=["pyopal_tpu/native/encoder.c"],
            extra_compile_args=["-O3"],
        ),
        Extension(
            "pyopal_tpu.native._results",
            sources=["pyopal_tpu/native/results.c"],
            extra_compile_args=["-O3"],
        ),
    ],
)

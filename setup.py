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
        "pyopal_tpu_torch.native",
        "pyopal_tpu_torch.ops",
        "pyopal_tpu_torch.parallel",
        "pyopal_tpu_torch.tests",
        "pyopal_tpu_torch.utils",
    ],
    package_data={
        "pyopal_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "py.typed", "*.pyi"],
        "pyopal_tpu_torch.native": ["*.c"],
        "pyopal_tpu_torch.parallel": ["*.pyi"],
    },
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
        # the PyTorch port's own copies (a source checkout builds them
        # at import instead: pyopal_tpu_torch/native/__init__.py)
        Extension(
            "pyopal_tpu_torch.native._encoder",
            sources=["pyopal_tpu_torch/native/encoder.c"],
            extra_compile_args=["-O3"],
        ),
        Extension(
            "pyopal_tpu_torch.native._results",
            sources=["pyopal_tpu_torch/native/results.c"],
            extra_compile_args=["-O3"],
        ),
    ],
)

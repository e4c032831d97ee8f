"""Packaging for knowhere_tpu (reference python/setup.py builds the SWIG
wheel; here the package is Python+ctypes with one native shared library)."""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Compile native/knowhere_native.cpp into the package tree."""

    def run(self):
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "knowhere_native.cpp")
        so = os.path.join(os.path.dirname(src), "libknowhere_native.so")
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", so],
                check=True,
            )
        except Exception as e:  # noqa: BLE001 — pure-python fallback exists
            print(f"warning: native build skipped ({e}); numpy fallbacks active")
        super().run()


setup(
    name="knowhere-tpu",
    version="0.1.0",
    description="TPU-native vector search (ANN) framework — JAX/XLA/Pallas rebuild of the Knowhere capability set",
    packages=find_packages(include=["knowhere_tpu", "knowhere_tpu.*", "knowhere_tpu_torch*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"knowhere_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    extras_require={"torch": ["torch"]},
    cmdclass={"build_py": BuildWithNative},
)

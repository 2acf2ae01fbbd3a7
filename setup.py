"""Packaging: builds the native core via make (the reference shells out to
meson+ninja the same way, reference setup.py:30-50) and ships the .so
inside the wheel. Console entry point mirrors the reference's `infinistore`
script (setup.py:74-78).

Wheel tagging: the native core is reached through ctypes, not a CPython
extension module, so ONE ``py3-none-<platform>`` wheel serves every CPython
>= 3.10 — where the reference must build a cp310/cp311/cp312 manylinux
matrix (reference build_manylinux_wheels.sh:1-22), we ship a single
platform wheel. The .so links only glibc/libstdc++ (no ibverbs analogue to
exclude); tools/build_wheel.sh runs the auditwheel policy check and the
fresh-venv install + smoke test."""

import os
import subprocess

from setuptools import setup
from setuptools.command.bdist_wheel import bdist_wheel
from setuptools.command.build_py import build_py
from setuptools.dist import Distribution

HERE = os.path.dirname(os.path.abspath(__file__))


class BuildNative(build_py):
    def run(self):
        native = os.path.join(HERE, "native")
        so = os.path.join(
            HERE, "infinistore_tpu", "_native", "libinfinistore_tpu.so"
        )
        if os.path.isdir(native):
            subprocess.run(
                ["make", "-j", str(os.cpu_count() or 2)], cwd=native, check=True
            )
        elif not os.path.exists(so):
            raise RuntimeError(
                "native/ sources missing and no prebuilt libinfinistore_tpu.so; "
                "the sdist must include native/** (see MANIFEST.in)"
            )
        super().run()


class BinaryDistribution(Distribution):
    """Force the platlib install layout: the package bundles a native .so,
    so the wheel root must be platlib (auditwheel rejects shared libraries
    under a purelib root)."""

    def has_ext_modules(self):
        return True


class PlatformWheel(bdist_wheel):
    """Tag the wheel py3-none-<plat>: platform-specific (bundled .so) but
    CPython-version-independent (ctypes FFI, no extension ABI)."""

    def get_tag(self):
        _, _, plat = super().get_tag()
        return "py3", "none", plat


setup(
    name="infinistore-tpu",
    version="0.1.0",
    description="TPU-native distributed KV-cache store for LLM inference clusters",
    packages=[
        "infinistore_tpu",
        "infinistore_tpu._native",
        "infinistore_tpu.tpu",
        "infinistore_tpu.models",
        "infinistore_tpu_torch",
        "infinistore_tpu_torch._native",
        "infinistore_tpu_torch.cuda",
        "infinistore_tpu_torch.models",
    ],
    package_data={
        "infinistore_tpu._native": ["libinfinistore_tpu.so"],
        "infinistore_tpu_torch.cuda": ["csrc/*.cu", "csrc/*.cuh"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=["numpy"],
    extras_require={"tpu": ["jax"], "cuda": ["torch"]},
    distclass=BinaryDistribution,
    cmdclass={"build_py": BuildNative, "bdist_wheel": PlatformWheel},
    entry_points={
        "console_scripts": [
            "infinistore-tpu = infinistore_tpu.server:main",
            "infinistore-tpu-benchmark = infinistore_tpu.benchmark:main",
        ]
    },
)

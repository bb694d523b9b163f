"""Package metadata; the native C++ module builds lazily at first import
(gubernator_tpu/native/__init__.py), so no build_ext is needed here."""

from setuptools import find_packages, setup

setup(
    name="gubernator-tpu",
    version="0.1.0",
    description="TPU-native distributed rate-limiting framework",
    packages=find_packages(include=["gubernator_tpu", "gubernator_tpu.*",
                                    "gubernator_tpu_torch",
                                    "gubernator_tpu_torch.*"]),
    package_data={"gubernator_tpu.native": ["*.cpp"],
                  "gubernator_tpu_torch": ["csrc/*.cu", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "grpcio",
        "protobuf",
        "prometheus_client",
    ],
    entry_points={
        "console_scripts": [
            "gubernator-tpu=gubernator_tpu.cmd.daemon:main",
            "gubernator-tpu-cli=gubernator_tpu.cmd.cli:main",
            "gubernator-tpu-cluster=gubernator_tpu.cmd.cluster_main:main",
        ]
    },
)

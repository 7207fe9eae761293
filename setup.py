"""Packaging (reference setup.py equivalent): installs the package and
builds the native preprocessing library in-place."""

import subprocess

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "build the native C++ preprocessing library"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        subprocess.run(["make", "-C", "native"], check=True)


setup(
    name="edgecape_tpu",
    version="0.1.0",
    description=("TPU-native one-/few-shot category-agnostic keypoint "
                 "estimation with learned skeleton edge weights"),
    packages=find_packages(include=["edgecape_tpu", "edgecape_tpu.*",
                                    "edgecape_tpu_torch",
                                    "edgecape_tpu_torch.*"]),
    package_data={"edgecape_tpu_torch": ["csrc/*.cu", "csrc/*.cc",
                                        "configs/train/*.py",
                                        "configs/test/*.py"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
    extras_require={"data": ["opencv-python"], "viz": ["matplotlib"],
                    "app": ["gradio"]},
    cmdclass={"build_native": BuildNative},
)

"""Test harness: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU backend even where an accelerator is visible:
JAX_PLATFORMS=cpu is set here and again through jax.config, which wins as
long as no backend has been initialized yet — conftest is imported before
any test module. XLA_FLAGS gives the CPU backend 8 devices for the mesh
tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import os

# Tests run on the CPU — with a virtual 8-device mesh for the sharding tests
# and float64 for cross-validation against scipy — unless JAX_PLATFORMS
# names another platform (the `gpu`-marked tests on a card, see README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags +
                               " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

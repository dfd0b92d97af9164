import os

# Multi-device lane (tests/test_engine_sharded.py): REPRO_VIRTUAL_DEVICES=8
# forces that many virtual CPU devices. The flag must land in XLA_FLAGS
# before jax initializes — conftest imports before any test module, and
# nothing here imports jax — so the whole pytest process runs on the forced
# topology. Without the env var nothing changes and the sharded tests skip.
_n = os.environ.get("REPRO_VIRTUAL_DEVICES")
if _n and "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_n}"
    ).strip()

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when torch sees none"
    )


@pytest.fixture(scope="session")
def virtual_devices():
    """The multi-device lane's 8 CPU devices; skips (not fails) on a plain
    single-device run so the fast/full lanes stay green without the flag."""
    import jax

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip(
            "needs >= 8 devices: run with REPRO_VIRTUAL_DEVICES=8 "
            "(the CI multi-device matrix entry does)"
        )
    return devs

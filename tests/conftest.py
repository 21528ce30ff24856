"""Test env: the CPU with 8 virtual devices (multi-device sharding sim),
unless JAX_PLATFORMS names another platform.

Must run before jax initializes a backend (SURVEY.md §4: multi-host logic is
tested via xla_force_host_platform_device_count on CPU). Tests marked `gpu`
run the compiled GPU kernels and skip without a GPU; on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags +
                               ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_enable_x64', False)

if os.environ['JAX_PLATFORMS'] == 'cpu':
    assert jax.device_count() >= 8, 'expected 8 virtual CPU devices'

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, not at import)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs a GPU: runs the compiled kernel, which has no '
                    'CPU form; chip_smoke.py covers it on the card')


@pytest.fixture(autouse=True, scope='module')
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules: ~80 tests of
    accumulated XLA programs push a small CPU box into memory pressure
    that segfaults the in-process CPU collectives of the (alphabetically
    last) 8-virtual-device sharding tests."""
    yield
    jax.clear_caches()

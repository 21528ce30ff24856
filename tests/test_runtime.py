"""Process set-up shared by the entry points: the compile cache, and the
refusal to measure without a GPU."""
import os

import jax
import pytest

from raytracer_tpu.utils import runtime


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', old)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    path = runtime.enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(checkout, '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: a second call gives the same one
    assert runtime.enable_compile_cache() == path


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match='no GPU'):
        runtime.require_gpu()


@pytest.mark.parametrize('entry', ['bench', 'chip_smoke'])
def test_entry_points_refuse_cpu(entry, monkeypatch, capsys, cache_config):
    """bench.py and chip_smoke.py stop with a non-zero exit and print no
    result line when JAX finds no GPU."""
    import importlib
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    monkeypatch.setattr(sys, 'argv', [entry])
    mod = importlib.import_module(entry)
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize('per_host,pid,expected', [
    (None, 3, None), ('4', 6, [2]), ('1', 5, [0])])
def test_one_gpu_per_process(monkeypatch, per_host, pid, expected):
    from raytracer_tpu.parallel import distributed
    monkeypatch.delenv('RT_PROCS_PER_HOST', raising=False)
    if per_host:
        monkeypatch.setenv('RT_PROCS_PER_HOST', per_host)
    assert distributed.local_device_ids(pid) == expected

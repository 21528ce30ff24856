"""Process set-up shared by the entry points (bench.py, chip_smoke.py, cli).

`enable_compile_cache()` keeps JAX's persistent compilation cache at a fixed
path, so a later process on the same checkout reuses compiled programs.
`require_gpu()` stops a measurement that finds no GPU instead of letting it
run on the CPU, and `gpu_name_and_power()` reads the card's name and power
limit (a card set below its maximum runs slower under load, so every
number is reported beside them).
"""
from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself;
    nothing else is set), otherwise <checkout>/.jax_cache. Returns the
    directory in use."""
    path = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if path:
        return path
    import jax
    path = os.path.join(CHECKOUT, '.jax_cache')
    jax.config.update('jax_compilation_cache_dir', path)
    return path


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """Device description of a GPU process; raises SystemExit without one."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'no GPU: JAX runs on {dev.platform} '
                         f'({dev.device_kind}); refusing to measure there')
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}

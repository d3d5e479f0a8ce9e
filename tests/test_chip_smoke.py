"""chip_smoke.py and its helpers on the CPU: the phase functions at tiny
sizes (the Pallas kernel in interpret mode), the no-GPU refusal, and the
compile-cache placement. The same phases run on the card at full size
from chip_smoke.py, and at small size from the ``gpu``-marked tests
below."""

import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_chip_smoke_refuses_without_gpu():
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed <repo>/.jax_cache path."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    code = ("import jax; from pbrt_tpu.utils import compile_cache as c; "
            "print(c.enable()); print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_cpu_env(**extra), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert p.stdout.split() == [want, want]


def test_phase_bench_tiny_interpret():
    res = chip_smoke.phase_bench(res=16, chunk=2, interpret=True,
                                 time_reps=1, spp=4)
    assert res["fused_kernel_ran"] and res["lanes"] == 512
    assert res["pixels_within_atol"] >= chip_smoke.PIX_FRAC
    assert len(res["fwdbwd_s_kernel"]) == 2


def test_phase_bvh_tiny():
    res = chip_smoke.phase_bvh(n_side=24, n_rays=4096, res=16, spp=1,
                               ray_chunk=512)
    assert res["triangles"] == 2 * 23 * 23
    assert res["hit_miss_agree"] == 1.0 and res["prim_agree"] == 1.0


def test_phase_sharded_tiny():
    res = chip_smoke.phase_sharded(n_dev=4, res=16, spp=4, train_spp=4)
    assert res["mesh"] == {"dp": 2, "sp": 2}
    assert res["result_devices"] == 4


def test_phase_cli_tiny():
    """2 spp is far below the oracle's budget, so only the plumbing and
    loose limits are checked here; main() holds the CLI to the oracle's
    limits at 32 spp."""
    res = chip_smoke.phase_cli(spp=2, md_max=0.5, bl_max=1.0)
    assert res["spp"] == 2 and res["mean_delta"] >= 0.0


@pytest.mark.gpu
def test_phase_bench_on_gpu(gpu_device):
    import jax
    with jax.default_device(gpu_device):
        res = chip_smoke.phase_bench(res=64, chunk=4)
    assert res["fused_calls_kernel"] >= 1 and res["fused_calls_li_loop"] == 0


@pytest.mark.gpu
def test_phase_bvh_on_gpu(gpu_device):
    import jax
    with jax.default_device(gpu_device):
        res = chip_smoke.phase_bvh(n_side=64, n_rays=8192, res=32, spp=2)
    assert res["hit_miss_agree"] >= 0.9999

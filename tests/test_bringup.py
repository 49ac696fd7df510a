"""Entry points and platform hygiene: the GPU requirement, the compile
cache, the CLI on the CPU, `chip_smoke.py`'s contract, and a package free of
flax/orbax and of Pallas kernels and backend probes."""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu():
    """The first GPU, or a skip where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run on the card with JAX_PLATFORMS=cuda,cpu")


def test_engine_imports_without_flax_or_orbax():
    code = (
        "import sys\n"
        "for m in ('flax', 'flax.linen', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[m] = None\n"
        "import instancefusion_tpu.engine.slam\n"
        "import instancefusion_tpu.engine.pipeline\n"
        "import instancefusion_tpu.cli\n"
        "import instancefusion_tpu.utils.checkpoint\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_has_no_pallas_kernels_or_backend_probes():
    bad = ("pallas.tpu", "pltpu", "default_backend()", "interpret=")
    hits = [
        f"{p.relative_to(REPO)}: {b}"
        for p in (REPO / "instancefusion_tpu").rglob("*.py")
        for b in bad
        if b in p.read_text()
    ]
    assert hits == []
    assert not (REPO / "instancefusion_tpu" / "ops" / "pallas").exists()


def test_seg_head_matches_flax_on_packaged_weights():
    nn = pytest.importorskip("flax.linen")
    from instancefusion_tpu.models import segmentation as segm

    class _ConvBlock(nn.Module):
        ch: int
        stride: int = 1

        @nn.compact
        def __call__(self, x):
            x = nn.Conv(self.ch, (3, 3), strides=(self.stride,) * 2)(x)
            return nn.gelu(nn.GroupNorm(num_groups=min(8, self.ch))(x))

    class PanopticHead(nn.Module):  # the flax module the weights came from
        num_classes: int
        width: int

        @nn.compact
        def __call__(self, rgb):
            w = self.width
            e1 = _ConvBlock(w)(rgb[None])
            e2 = _ConvBlock(w * 2, 2)(e1)
            e3 = _ConvBlock(w * 4, 2)(e2)
            e4 = _ConvBlock(w * 8, 2)(e3)
            m = _ConvBlock(w * 8)(e4)

            def up(x, skip, ch):
                x = jax.image.resize(
                    x, (1, skip.shape[1], skip.shape[2], x.shape[3]), "bilinear")
                return _ConvBlock(ch)(jax.numpy.concatenate([x, skip], -1))

            d3 = up(m, e3, w * 4)
            d2 = up(d3, e2, w * 2)
            d1 = up(d2, e1, w)
            return (nn.Conv(self.num_classes, (1, 1))(d1)[0],
                    nn.Conv(1, (1, 1))(d1)[0, ..., 0],
                    nn.Conv(2, (1, 1))(d1)[0])

    params, nc, width = segm.load_pretrained()
    rgb = jax.random.uniform(jax.random.PRNGKey(1), (60, 80, 3))
    want = PanopticHead(nc, width).apply(params, rgb)
    got = segm.head_apply(params, rgb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)
    # A fresh init has the packaged checkpoint's tree and shapes.
    fresh = segm.init_params(jax.random.PRNGKey(0), 8, 8, nc, width)
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, params)


def test_make_mesh_raises_on_too_few_devices():
    from instancefusion_tpu.parallel.mesh import make_mesh

    assert make_mesh(2).shape["shards"] == 2
    with pytest.raises(ValueError, match="need"):
        make_mesh(jax.device_count() + 1)


def test_compile_cache_keeps_env_dir(monkeypatch, tmp_path):
    from instancefusion_tpu.utils import runtime

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from instancefusion_tpu.utils import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:  # tests run without a persistent cache (conftest.py)
        jax.config.update("jax_compilation_cache_dir", before)


def test_setup_requires_a_gpu_unless_told_otherwise():
    from instancefusion_tpu.utils import runtime

    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.setup(None)
    assert runtime.setup("cpu").platform == "cpu"


@pytest.mark.parametrize("preset,extra", [
    ("config1", []),
    ("config2", ["--loops"]),
    ("config3", ["--instances", "--seg-head", "trained"]),
], ids=["config1", "config2-loops", "config3-head"])
def test_cli_small_cpu_run(capsys, preset, extra):
    from instancefusion_tpu import cli

    rc = cli.main(["run", "--preset", preset, "--small", "--platform", "cpu",
                   "--frames", "3", "--quiet", *extra])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    s = summary["summary"]
    # Three frames span the orbit's whole sweep: a run, not an accuracy test.
    assert s["frames"] == 3 and np.isfinite(s["ate_rmse_m"])
    if preset == "config3":
        assert s["blocks"] > 0 and "voted_voxels" in s


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_refuses_a_cpu_device():
    cs = _chip_smoke()
    with pytest.raises(cs.SmokeFailure, match="not gpu"):
        cs.require_gpu(jax.devices())


def test_chip_smoke_result_line_has_exactly_the_contract_keys():
    cs = _chip_smoke()
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = json.loads(cs.result_line([dev]))
    assert line == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100", "count": 1}}


def test_chip_smoke_fails_alone_and_without_a_gpu(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (tmp_path, REPO):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_chip_parity_small(gpu):
    """The GPU-vs-CPU parity phase of chip_smoke.py at test widths."""
    import dataclasses

    from instancefusion_tpu.config import PRESETS, TsdfConfig
    from instancefusion_tpu.geometry.camera import Intrinsics

    # (No `tests.` imports: a site-packages `tests` can shadow them there.)
    cfg = dataclasses.replace(
        PRESETS["config2"](),
        intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5,
                              width=160, height=120),
        tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                        origin=(-1.92, -1.92, -0.4), table_capacity=2048,
                        touched_capacity=512))
    _chip_smoke().parity(cfg, gpu, jax.devices("cpu")[0])

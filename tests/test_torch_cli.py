"""Port parity: the CLI, its refusals, and the port's independence from JAX."""

import json

import os
import subprocess
import sys

import pytest
import torch

from raytracingc_tpu.cli import build_parser as j_build_parser
from raytracingc_tpu.cli import main as j_main
from raytracingc_tpu_torch.cli import build_parser, main
from raytracingc_tpu_torch.render.image import read_bmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_SCENE = os.path.join(REPO, "examples", "box_scene.txt")
SMALL = ["--triangles", BOX_SCENE, "-s", "16", "16", "--spp", "4", "-b", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity renders run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.nargs, a.choices, a.type)
        for a in parser._actions if a.dest != "help"
    }


def test_parser_matches_jax():
    port, ref = _options(build_parser()), _options(j_build_parser())
    # The port's own flags: --device, and --dist-backend (torch.distributed's
    # backend; jax.distributed has none to choose).
    assert port.pop("device") == (("--device",), "cuda", None, ["cuda", "cpu"], None)
    assert port.pop("dist_backend") == (("--dist-backend",), None, None,
                                        ["nccl", "gloo"], None)
    assert port == ref


def test_cpu_render_matches_jax_cli(tmp_path, capsys):
    out, ref = str(tmp_path / "port.bmp"), str(tmp_path / "jax.bmp")
    assert j_main(SMALL + ["-o", ref]) == 0
    assert main(SMALL + ["--device", "cpu", "-o", out, "--profile"]) == 0
    log = capsys.readouterr().out
    assert log.count("rays traced") == 2 and "rays=" in log
    got, want = read_bmp(out), read_bmp(ref)
    assert got.shape == want.shape == (16, 16, 3)
    assert abs(got.mean() / 255.0 - want.mean() / 255.0) <= 0.01


def test_cpu_backends_and_tessellate(tmp_path):
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    assert main(SMALL + ["--device", "cpu", "--backend", "xla", "-o", a]) == 0
    # 640 triangles tile the same surfaces: the same image up to float noise.
    assert main(SMALL + ["--device", "cpu", "--tessellate", "3", "-o", b]) == 0
    assert abs(read_bmp(a).mean() - read_bmp(b).mean()) <= 0.01 * 255
    with pytest.raises(SystemExit, match="needs --device cuda"):
        main(SMALL + ["--device", "cpu", "--backend", "pallas", "-o", a])


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.bmp"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(SMALL + ["-o", str(out)])  # --device defaults to cuda
    assert not out.exists()


@pytest.mark.parametrize(
    "flags",
    [
        ["--dist-backend", "gloo"],
        ["--scene-sharding", "blocks"],
        ["--scene-sharding", "blocks", "--checkpoint", "x.npz"],
        ["--scene-sharding", "blocks", "--debug-bounces"],
        ["--coordinator", "localhost:1234"],
        ["--num-processes", "2"],
        ["--process-id", "0"],
    ],
)
def test_unported_flags_raise(flags, tmp_path):
    """Every flag is ported; these combinations are refused before any
    work: the JAX CLI's guard on --scene-sharding blocks, and the
    multi-process flags given apart (torch.distributed needs all three)."""
    out = tmp_path / "never.bmp"
    with pytest.raises(SystemExit,
                       match="requires --shard|go together|needs --coordinator"):
        main(SMALL + ["--device", "cpu", "-o", str(out)] + flags)
    assert not out.exists()


def test_checkpoint_flag(tmp_path, capsys):
    """--checkpoint --batch-spp: a progressive render whose checkpoint holds
    every sample; its BMP within 1 byte of the one-shot render's (the
    sample average re-associates), the same traced rays; a rerun resumes
    from the finished checkpoint and writes the same bytes."""
    import numpy as np

    one, prog, again = (str(tmp_path / f"{k}.bmp") for k in ("one", "prog", "again"))
    ck = str(tmp_path / "ck.npz")
    cpu = SMALL + ["--device", "cpu", "--profile"]
    assert main(cpu + ["-o", one]) == 0
    assert main(cpu + ["-o", prog, "--checkpoint", ck, "--batch-spp", "3"]) == 0
    assert main(cpu + ["-o", again, "--checkpoint", ck, "--batch-spp", "3"]) == 0
    rays = [int(ln.split("rays=")[1].split()[0])
            for ln in capsys.readouterr().out.splitlines() if "[profile]" in ln]
    assert rays[0] == rays[1] > 0 and rays[2] == rays[1]
    with np.load(ck) as data:
        assert int(data["__step__"]) == 4 and int(data["leaf_1"]) == rays[0]
    a, b = read_bmp(one).astype(int), read_bmp(prog).astype(int)
    assert np.abs(a - b).max() <= 1
    with open(prog, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()


def test_batch_spp_alone_is_accepted(tmp_path):
    """--batch-spp without --checkpoint is accepted and unused, as in the JAX
    package: the one-shot render's bytes."""
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    assert main(SMALL + ["--device", "cpu", "-o", a]) == 0
    assert main(SMALL + ["--device", "cpu", "-o", b, "--batch-spp", "16"]) == 0
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_debug_bounces_matches_jax_cli(tmp_path, capsys):
    """--debug-bounces: the heatmap's BMP against the JAX CLI's (bytes equal
    on >= 99.5% of pixels, the render_debug rule; observed: equal), one
    traced ray per pixel."""
    import numpy as np

    out, ref = str(tmp_path / "port.bmp"), str(tmp_path / "jax.bmp")
    flags = ["--triangles", BOX_SCENE, "-s", "24", "16", "-b", "4",
             "--seed", "3", "--debug-bounces"]
    assert j_main(flags + ["-o", ref]) == 0
    assert main(flags + ["--device", "cpu", "-o", out, "--profile"]) == 0
    assert "rays=384 " in capsys.readouterr().out
    got, want = read_bmp(out), read_bmp(ref)
    assert got.shape == want.shape == (16, 24, 3)
    assert set(np.unique(got)) <= {0, 63, 127, 191, 255}
    assert (got == want).all(-1).mean() >= 0.995


def test_trace_flag_writes_a_chrome_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    out = str(tmp_path / "t.bmp")
    assert main(SMALL + ["--device", "cpu", "-o", out, "--trace", str(trace_dir)]) == 0
    files = list(trace_dir.glob("*.json"))
    assert len(files) == 1 and str(files[0]) in capsys.readouterr().out
    events = json.loads(files[0].read_text())["traceEvents"]
    # The render's torch ops are in it (on a card, its kernels too).
    assert sum(e.get("name", "").startswith("aten::") for e in events) > 100
    assert os.path.exists(out)


@pytest.mark.parametrize(
    "env,exc",
    [
        ({"RTC_KERNEL": "bitmask"}, ValueError),
        ({"RTC_EXTRACT": "rolll"}, ValueError),
        ({"RTC_MXU_PRECISION": "bf16"}, ValueError),
        ({"RTC_BRUTE_MAX": "lots"}, ValueError),
        ({"RTC_BRUTE_MAX": "-1"}, ValueError),
    ],
)
def test_bad_knobs_raise(env, exc, tmp_path, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc):
        main(SMALL + ["--device", "cpu", "-o", str(tmp_path / "x.bmp")])


def test_port_never_imports_jax():
    code = (
        "import pkgutil, sys\n"
        "import raytracingc_tpu_torch\n"
        "for m in pkgutil.walk_packages(raytracingc_tpu_torch.__path__,\n"
        "                               'raytracingc_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import raytracingc_tpu_torch.cli\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k in ('jax', 'raytracingc_tpu')\n"
        "             or k.startswith(('jax.', 'raytracingc_tpu.')))\n"
        "assert not bad, bad\n"
        "from raytracingc_tpu_torch.ops import _build\n"
        "assert _build._lib is None  # importing builds nothing\n"
        "print('ok', len(list(pkgutil.walk_packages(raytracingc_tpu_torch.__path__))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")

"""chip_smoke.py at tiny sizes on the CPU: every phase's comparison, the
data generator, and the refusal to report on anything but a GPU. The
full-size run needs a GPU (`python chip_smoke.py`)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {"reads": 4000, "read_len": 150, "genome": 50_000}


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke")
    path = str(work / "reads.fq")
    rec_len = chip_smoke.write_fastq(path, np.random.default_rng(1),
                                     **TINY)
    return str(work), path, rec_len


@pytest.fixture(scope="module")
def db():
    return chip_smoke.clustered_db(np.random.default_rng(2), 300, 64)


def _run_script(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    proc = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_write_fastq_shape(fastq):
    from finch_tpu.native import KmerReader

    _, path, rec_len = fastq
    assert os.path.getsize(path) == TINY["reads"] * rec_len
    reader = KmerReader(path, k=21, batch_size=1 << 16)
    n = sum(len(pk) for pk, _ in reader)
    assert n == TINY["reads"] * (TINY["read_len"] - 21 + 1)
    seq_len, valid, _ = reader.totals
    assert seq_len == TINY["reads"] * TINY["read_len"]


def test_phase_read_set(fastq):
    work, path, _ = fastq
    r = chip_smoke.phase_read_set(work, path, 100, dev_backend="jax",
                                  require_gpu=False)
    assert r["engine"] == "JaxEngine"
    assert r["hashes"] > 0


def test_phase_step():
    out = chip_smoke.phase_step(np.random.default_rng(3), 1 << 17, 2000, 3)
    assert [r["stream"] for r in out[1:]] == [
        "uniform", "tiled_dup64", "shuffled_dup64"]
    assert all(r["copy_bytes"] == 2 * 9 * (1 << 17) for r in out[1:])


def test_phase_scaled_wide(fastq):
    work, path, rec_len = fastq
    out = chip_smoke.phase_scaled_wide(work, path, rec_len, 0.05,
                                       3000 * rec_len, dev_backend="jax")
    assert out[0]["grows"] > 0
    assert out[-1]["slice_bytes"] == 3000 * rec_len


def test_phase_dist(tmp_path, db):
    out = chip_smoke.phase_dist(str(tmp_path), np.random.default_rng(4),
                                db, 300, 500)
    grams = [r for r in out if r["phase"] == "4_gram"]
    assert [g["dot_operand_dtypes"] for g in grams] == [["int8"],
                                                        ["bfloat16"]]
    runs = {r["run"]: r["rows"] for r in out if r["phase"] == "4_cli_dist"}
    assert runs["pairwise"] == 300 * 299
    assert runs["queries"] > 0


def test_phase_four_cards(fastq, db):
    work, path, _ = fastq
    out = chip_smoke.phase_four_cards(work, path, 100, db[:200],
                                      dev_backend="mesh")
    assert [r["phase"] for r in out] == ["5_sketch", "5_sketch", "5_gram",
                                         "5_tile"]
    assert out[0]["engine"] == "ShardedSketchEngine"


@pytest.fixture
def gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"],
                                     capture_output=True).returncode:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")


@pytest.mark.gpu
def test_full_smoke_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith('{"ok": true')

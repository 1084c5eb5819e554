"""examples/quickstart_torch.py, the reference quickstart on the port: its
tiny preset on the CPU for a few steps trains, "crashes", resumes from the
latest checkpoint and finishes; run again, it resumes from the last one.

A plumbing test of the demo's flow (its printed markers and resume), not of
its numbers: it does not run examples/quickstart.py. The pieces it drives
are held to the reference by twins: the trainer in
test_torch_hemt_driver.py, the checkpointer and manager in
test_torch_checkpoint.py."""
import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(HERE, "..", "examples", "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_tiny_trains_crashes_and_resumes(capsys, tmp_path):
    qs = _quickstart()
    ckpt = str(tmp_path / "ckpt")
    qs.main(["--device", "cpu", "--steps", "6", "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "step    0 loss" in out
    # kill at step 3 (60 % of 6), after the checkpoint of step 3
    assert "[fault] simulating crash at step 3; resuming from latest checkpoint 3" in out
    assert out.splitlines()[-1].startswith("done: total fleet time")
    losses = [float(ln.split()[3]) for ln in out.splitlines() if ln.startswith("step")]
    assert all(loss == loss and loss < 10.0 for loss in losses)
    qs.main(["--device", "cpu", "--steps", "6", "--ckpt", ckpt])
    again = capsys.readouterr().out
    assert again.splitlines()[0] == "[resume] from step 6"
    assert "[fault]" not in again


@pytest.mark.gpu
def test_quickstart_tiny_on_card(capsys, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _quickstart().main(["--device", "cuda", "--preset", "tiny", "--steps", "6",
                        "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "resuming from latest checkpoint 3" in out and "done:" in out

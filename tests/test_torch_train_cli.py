"""The port's train CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``) on the same flags, on the CPU: the
same printed grains, makespans and idles, losses within the bf16 configs'
tolerance, and resumption from a checkpoint either package wrote.
"""
import json
import sys

import pytest
import torch

torch.set_num_threads(2)

FLAGS = ["--steps", "4", "--global-batch", "8", "--seq-len", "16", "--slices", "1.0,0.4"]


def _run(main, monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    main()
    out = capsys.readouterr().out.splitlines()
    return [json.loads(ln) for ln in out if ln.startswith("{")], \
        [ln for ln in out if not ln.startswith("{")]


def _port(monkeypatch, capsys, argv):
    from repro_torch.launch.train import main
    return _run(main, monkeypatch, capsys, [*argv, "--device", "cpu"])


def _ref(monkeypatch, capsys, argv):
    from repro.launch.train import main
    return _run(main, monkeypatch, capsys, argv)


def _same_params_in_float32(monkeypatch):
    """Both CLIs on float32 reduced configs, and the port's initial state
    converted from the reference's (the two packages draw their random
    weights differently)."""
    import dataclasses

    import jax
    import numpy as np

    from repro.launch import train as j_train
    from repro.runtime.train_loop import train_state_init as j_init
    from repro_torch import convert
    from repro_torch.launch import train as t_train
    from repro_torch.runtime.train_loop import train_state_from_params

    for mod in (j_train, t_train):
        reduced = mod.get_reduced
        monkeypatch.setattr(mod, "get_reduced",
                            lambda a, _r=reduced: dataclasses.replace(_r(a), dtype="float32"))

    def init(seed, cfg, bundle, *, device):
        import repro.configs as jc
        jcfg = dataclasses.replace(jc.get_reduced(cfg.name.replace("-reduced", "")),
                                   dtype="float32")
        jst = j_init(jax.random.PRNGKey(seed), jcfg, jc.ArchBundle(model=jcfg))
        params = convert.from_jax_params(jax.tree.map(np.asarray, jst.params), cfg,
                                         device=device)
        return train_state_from_params(params, bundle)

    monkeypatch.setattr(t_train, "train_state_init", init)


@pytest.mark.parametrize("arch,mode", [("granite-3-8b", "hemt"), ("mamba2-2.7b", "homt"),
                                       ("granite-3-8b", "static-even")])
def test_train_cli_matches_reference(monkeypatch, capsys, arch, mode):
    _same_params_in_float32(monkeypatch)
    argv = [*FLAGS, "--arch", arch, "--mode", mode]
    got, got_text = _port(monkeypatch, capsys, argv)
    want, want_text = _ref(monkeypatch, capsys, argv)
    assert [r["step"] for r in got] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        assert (g["step"], g["grains"], g["makespan_s"], g["idle_s"]) == \
            (w["step"], w["grains"], w["makespan_s"], w["idle_s"])
        assert g["loss"] == pytest.approx(w["loss"], abs=2e-4)    # printed to 4 places
    assert got_text == want_text          # total fleet time, mean idle, mode


def test_train_cli_resumes_from_its_checkpoint(monkeypatch, capsys, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--global-batch", "8", "--seq-len", "16", "--ckpt-every", "2", "--ckpt", ckpt]
    first, text = _port(monkeypatch, capsys, [*argv, "--steps", "3"])
    assert [r["step"] for r in first] == [0, 1, 2] and not any("resumed" in t for t in text)
    second, text = _port(monkeypatch, capsys, [*argv, "--steps", "5"])
    assert "resumed from step 3" in text
    assert [r["step"] for r in second] == [3, 4]
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(ckpt).steps() == [3, 4, 5]     # keep=3


def test_train_cli_resumes_from_the_references_checkpoint(monkeypatch, capsys, tmp_path):
    """The reference trains 2 steps and checkpoints; the port's CLI resumes
    there, and its next losses match the reference's own continuation."""
    argv = ["--arch", "mamba2-2.7b", "--global-batch", "8", "--seq-len", "16",
            "--ckpt-every", "1"]
    _ref(monkeypatch, capsys, [*argv, "--steps", "2", "--ckpt", str(tmp_path / "a")])
    _ref(monkeypatch, capsys, [*argv, "--steps", "2", "--ckpt", str(tmp_path / "b")])
    got, text = _port(monkeypatch, capsys, [*argv, "--steps", "4", "--ckpt", str(tmp_path / "a")])
    want, wtext = _ref(monkeypatch, capsys, [*argv, "--steps", "4", "--ckpt", str(tmp_path / "b")])
    assert "resumed from step 2" in text and "resumed from step 2" in wtext
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 3]
    for g, w in zip(got, want):
        assert (g["grains"], g["makespan_s"], g["idle_s"]) == (w["grains"], w["makespan_s"],
                                                               w["idle_s"])
        assert g["loss"] == pytest.approx(w["loss"], rel=5e-3)

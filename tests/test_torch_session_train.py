"""The port's training runtime on the CPU at the qwen3-1.7b SMOKE config:
`Session.train` -> `TransientTrainer.run_steps` events, membership epochs,
writer-lease handover, checkpoint/resume (with the saved compression
scheme and the legacy layout without a residual), `serve()` after
`train()` and the CLI. The asynchronous-PS mode is held against the
reference in tests/test_torch_ps_async.py."""
import json
import tempfile

import pytest
import torch

from repro_torch.__main__ import main
from repro_torch.api import Session
from repro_torch.api.serving import generate
from repro_torch.checkpoint import Checkpointer, WriterLease
from repro_torch.core.trainer import MembershipEvent
from repro_torch.tree import flatten

KW = dict(global_batch=4, seq_len=16)


def _session(**run):
    return Session.from_arch("qwen3-1.7b", device="cpu", lr=1e-3,
                             warmup_steps=1, total_steps=8, **run)


def test_train_emits_events_and_resumes(tmp_path):
    s = _session(checkpoint_interval=2)
    rep = s.train(4, members=2, checkpoint_dir=str(tmp_path),
                  events=[MembershipEvent(2, "revoke", 1)], **KW)
    assert rep.steps_run == 4 and rep.epochs == 2 and rep.checkpoints == 2
    assert len(rep.grad_norms) == 4 and rep.restores == 0
    assert [e.payload["step"] for e in s.bus.of_kind("step")] == [0, 1, 2, 3]
    assert [e.payload["step"] for e in s.bus.of_kind("checkpoint")] == [2, 4]
    (ep,) = s.bus.of_kind("epoch")
    assert ep.payload == {"step": 2, "kind": "revoke", "member_id": 1,
                          "epoch": 1, "n_alive": 1}
    meta = json.load(open(tmp_path / "step_4" / "meta.json"))
    assert meta["step"] == 4 and meta["grad_compression"] == "none"

    again = _session(checkpoint_interval=2)
    rep2 = again.train(2, checkpoint_dir=str(tmp_path), **KW)
    assert [e.payload["step"] for e in again.bus.of_kind("restore")] == [4]
    assert [e.payload["step"] for e in again.bus.of_kind("step")] == [4, 5]
    assert rep2.restores == 1 and all(l == l for l in rep2.losses)


def test_revoked_writer_hands_the_lease_over(tmp_path):
    # the chief (worker-1) holds an unexpired lease; its revocation frees
    # it and the survivor takes it before the first save
    assert WriterLease(str(tmp_path), "worker-1").try_acquire()
    s = _session(checkpoint_interval=2)
    rep = s.train(2, members=2, holder="worker-0",
                  checkpoint_dir=str(tmp_path),
                  events=[MembershipEvent(1, "revoke", 1)], **KW)
    (ho,) = s.bus.of_kind("lease_handover")
    assert ho.payload == {"step": 1, "holder": "worker-0",
                          "revoked_member": 1}
    assert rep.checkpoints == 1


def test_join_rolls_the_epoch(tmp_path):
    s = _session(checkpoint_interval=0)
    rep = s.train(3, members=1, checkpoint_dir=str(tmp_path),
                  events=[MembershipEvent(1, "join", 5),
                          MembershipEvent(2, "join", 5)], **KW)  # stale
    assert rep.epochs == 2
    assert [e.payload["n_alive"] for e in s.bus.of_kind("epoch")] == [2]


def test_checkpoint_outage_drops_saves(tmp_path):
    s = _session(checkpoint_interval=1)
    s.train(1, checkpoint_dir=str(tmp_path), **KW)
    trainer = s.trainer
    trainer.inject_fault("ckpt_outage", step=1)
    state, _ = trainer.restore_or_init()
    state, rep = trainer.run_steps(state, 2)
    assert rep.checkpoint_failures == 2 and rep.checkpoints == 0
    assert [e.payload["failures"] for e in s.bus.of_kind(
        "checkpoint_failed")] == [1, 2]
    trainer.inject_fault("ckpt_recover", step=3)
    _, rep = trainer.run_steps(state, 1)
    assert rep.checkpoints == 1
    with pytest.raises(ValueError, match="unknown fault"):
        trainer.inject_fault("meteor")


def test_resume_keeps_the_saved_compression(tmp_path):
    s = _session(checkpoint_interval=2, grad_compression="int8")
    s.train(2, checkpoint_dir=str(tmp_path), **KW)
    again = _session(checkpoint_interval=2)          # config says "none"
    again.train(1, checkpoint_dir=str(tmp_path), **KW)
    assert again.trainer.run.grad_compression == "int8"
    (step,) = again.bus.of_kind("step")
    assert step.payload["grad_compression"] == "int8"
    assert step.payload["payload_bytes"] > 0


def test_legacy_checkpoint_restores_with_zero_residual(tmp_path):
    s = _session(checkpoint_interval=2)
    s.train(2, checkpoint_dir=str(tmp_path), **KW)  # no residual entries
    again = _session(checkpoint_interval=2, grad_compression="int8")
    again.train(1, checkpoint_dir=str(tmp_path), **KW)
    assert [e.payload["step"] for e in again.bus.of_kind("restore")] == [2]
    assert "payload_bytes" in again.bus.of_kind("step")[0].payload


def test_serve_after_train_serves_the_trained_weights(tmp_path):
    s = _session(checkpoint_interval=0)
    before = {p: t.clone() for p, t in flatten(s.params)}
    s.train(2, checkpoint_dir=str(tmp_path), **KW)
    after = dict(flatten(s.params))
    assert all(not torch.equal(before[p], after[p]) for p in before)
    prompt = torch.randint(0, s.cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(0))
    got = s.serve(tokens=3, batch=2, prompt_len=5, prompt=prompt)
    want = generate(s.cfg, s.params, batch=2, prompt_len=5, tokens=3,
                    prompt=prompt, device="cpu")
    assert torch.equal(got.generated, want.generated)


def test_default_checkpoint_dir_is_arch_namespaced(tmp_path, monkeypatch):
    """The reference's default directory lies under TMPDIR and gets the
    arch appended, so runs of different models never restore each other's
    trees (TMPDIR is pointed into tmp_path here)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    s = _session(checkpoint_interval=0)
    assert s.run.checkpoint_dir == str(tmp_path / "repro_ckpt")
    s.train(1, **KW)
    assert s.trainer.run.checkpoint_dir == str(tmp_path / "repro_ckpt" /
                                               "qwen3-1.7b")
    s.train(1, checkpoint_dir=str(tmp_path / "x"), **KW)   # verbatim
    assert s.trainer.run.checkpoint_dir == str(tmp_path / "x")


def test_cli_train(tmp_path, capsys):
    args = ["train", "--device", "cpu", "--steps", "3", "--members", "3",
            "--revoke-at", "1", "--checkpoint-interval", "2",
            "--checkpoint-dir", str(tmp_path), "--global-batch", "6",
            "--seq", "16"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "epochs=2" in out and "checkpoints=1" in out
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    assert main(args) == 0
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out


def test_cli_train_needs_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["train", "--steps", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


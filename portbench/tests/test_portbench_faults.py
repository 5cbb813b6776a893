"""A run with the timed path broken underneath comes out not correct under
the real cells' limits: a step that leaves the state unchanged, half of the
batch left out of the loss, a token altered where the feed produces it, the
SSD's output rounded to bf16 where the scan produces it.  The
look for a card is skipped: the rest of a run goes on the CPU at a tiny size
(the port's plain route in f32), where a sound run is correct."""
import pytest
import torch

import portbench.run as run
from portbench.tests.tiny import add_tiny, copy_bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    base = copy_bench(tmp)
    return tmp, base, {fam: add_tiny(base, fam) for fam in ("ssm",)}


def _execute(bench, family, seed=2 ** 31 + 99):
    tmp, base, cells = bench
    return run.execute(cells[family], seed, 0.3, False, torch.device("cpu"), base=base,
                       root=tmp)


def _unchanged(monkeypatch):
    from repro_torch.train import optimizer

    def apply_updates(params, grads, state, cfg):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(optimizer, "apply_updates", apply_updates)


def _half_batch(monkeypatch):
    from repro_torch.train import step

    orig = step.cross_entropy

    def cross_entropy(logits, labels, z_loss=1e-4):
        labels = labels.clone()
        if labels.shape[0] > 1:
            labels[labels.shape[0] // 2:] = step.PAD_ID
        else:
            labels[:, labels.shape[1] // 2:] = step.PAD_ID
        return orig(logits, labels, z_loss)

    monkeypatch.setattr(step, "cross_entropy", cross_entropy)


def _token_altered(monkeypatch):
    from repro_torch.feed import feeder

    orig = feeder.DeviceFeeder.next

    def next_batch(self, timeout=None):
        batch = orig(self, timeout)
        batch["tokens"][0, -1] = batch["tokens"][0, -1] % 200 + 1
        return batch

    monkeypatch.setattr(feeder.DeviceFeeder, "next", next_batch)


def _ssd_output_in_bf16(monkeypatch):
    from repro_torch.models import layers

    orig = layers.ssd_scan

    def ssd_scan(*args, **kwargs):
        y, h = orig(*args, **kwargs)
        return y.to(torch.bfloat16).to(y.dtype), h

    monkeypatch.setattr(layers, "ssd_scan", ssd_scan)


@pytest.mark.parametrize("family", ["ssm"])
def test_a_sound_run_is_correct(bench, family):
    out = _execute(bench, family)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4


@pytest.mark.parametrize("family", ["ssm"])
@pytest.mark.parametrize("fault,number", [(_unchanged, "update_gap"),
                                          (_half_batch, "loss_gap"),
                                          (_token_altered, "batch_mismatches"),
                                          (_ssd_output_in_bf16, "ssd_gap")])
def test_a_broken_step_is_not_correct(bench, family, fault, number, monkeypatch):
    fault(monkeypatch)
    out = _execute(bench, family)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]

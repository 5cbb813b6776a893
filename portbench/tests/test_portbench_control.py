"""The controls: the plain reference in the program's place, computed in
e4m3 (the precision below the configuration's bf16 compute), or with only
the SSD's products in TF32 or bf16 (below its f32 SSD).  On the card, at a
cell's own size, the e4m3 control must come out not correct under the
cell's limits (``limits.py`` read every control on three seeds when the
limits were set); on the CPU at a tiny size each control reads far above a
sound run."""
import pytest
import torch

from portbench.bench import compare, layout, reference
from portbench.tests.tiny import add_tiny, copy_bench

SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


def _readings(cell, seed, device, **kw):
    m = cell.config["model"]
    batches = cell.source.batches(cell.traffic, cell.token_ids, seed,
                                  cell.traffic["setup_steps"])
    return reference.train_steps(cell.family, m, cell.config["optimizer"],
                                 cell.traffic["schedule"], seed, batches, device, **kw)


@pytest.fixture(scope="module")
def tiny_sound(tmp_path_factory):
    base = copy_bench(tmp_path_factory.mktemp("bench"))
    cell = layout.load_cell(add_tiny(base, "ssm"), base)
    ref = _readings(cell, SEEDS[0], "cpu")
    prog = cell.driver.Program(cell, SEEDS[0], torch.device("cpu"))
    sound = compare.gaps(prog.first_steps(), ref)
    prog.close()
    return cell, ref, sound


@pytest.mark.parametrize("precision", ["fp8", "ssd_bf16", "ssd_tf32"])
def test_the_control_reads_far_above_a_sound_run(tiny_sound, precision):
    cell, ref, sound = tiny_sound
    control = compare.gaps(_readings(cell, SEEDS[0], "cpu", precision=precision), ref)
    assert max(control[k] / max(sound[k], 1e-12) for k in control) > 100, (sound, control)


@pytest.mark.card
@pytest.mark.parametrize("cell_name", layout.names("workloads"))
def test_the_control_is_not_correct_on_the_card(card, cell_name):
    import gc

    cell = layout.load_cell(cell_name)
    number = getattr(cell.family, "KERNEL_NUMBER", None)
    for seed in SEEDS:
        if number is not None:  # the kernel call's controls, on the program's own call
            prog = cell.driver.Program(cell, seed, card)
            call = prog.first_steps()["kernel_call"]
            prog.close()
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            for lower in ("tf32", "bf16"):
                gap = cell.driver.kernel_gap(cell, call, card, lower)
                assert gap > cell.limits[number], (seed, lower, gap)
        ref = _readings(cell, seed, card)
        control = _readings(cell, seed, card, precision="fp8")
        checks = compare.judge({"batch_mismatches": 0.0, **compare.gaps(control, ref)},
                               cell.limits)
        assert not compare.correct(checks), checks


@pytest.mark.parametrize("lower", ["tf32", "bf16"])
def test_the_kernel_call_control_reads_above_the_programs(tiny_sound, lower):
    """The SSD call of the timed path worked out again with its products in
    TF32 or bf16 reads above the program's own call (its f32 plain version
    here) against the f32 reference."""
    cell = tiny_sound[0]
    prog = cell.driver.Program(cell, SEEDS[1], torch.device("cpu"))
    call = prog.first_steps()["kernel_call"]
    prog.close()
    sound = cell.driver.kernel_gap(cell, call, torch.device("cpu"))
    control = cell.driver.kernel_gap(cell, call, torch.device("cpu"), lower)
    assert control > 5 * sound, (sound, control)

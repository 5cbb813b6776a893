"""The plain reference agrees with the port's CPU plain route, and the
weights drawn again from the seed piece by piece are the weights made."""
import pytest
import torch

from portbench.bench import compare, layout, reference
from portbench.tests.tiny import add_tiny, copy_bench


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    b = copy_bench(tmp_path_factory.mktemp("bench"))
    add_tiny(b, "ssm")
    return b


@pytest.mark.parametrize("family", ["ssm"])
def test_reference_agrees_with_the_ports_plain_route(base, family):
    """Three steps of the port (its CPU plain route, f32) from the
    benchmark's weights and feed, against the reference's three steps."""
    cell = layout.load_cell(f"tiny-{family}.cell", base)
    seed = 2 ** 31 + 7
    prog = cell.driver.Program(cell, seed, torch.device("cpu"))
    readings = prog.first_steps()
    prog.close()
    m = cell.config["model"]
    batches = cell.source.batches(cell.traffic, cell.token_ids, seed, 3)
    ref = reference.train_steps(cell.family, m, cell.config["optimizer"],
                                cell.traffic["schedule"], seed, batches, "cpu")
    g = compare.gaps(readings, ref)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-4 and g["update_gap"] < 1e-4, g
    assert len(ref["grad1"]) == len(list(prog.table.pieces()))


@pytest.mark.parametrize("family", ["ssm"])
def test_pieces_drawn_again_equal_the_weights(base, family, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 1000)  # pieces that straddle blocks
    cell = layout.load_cell(f"tiny-{family}.cell", base)
    table = reference.LeafTable(cell.family.leaf_shapes(cell.config["model"]))
    flat = reference.make_flat(table, 11, "cpu", cell.family.init_rules(cell.config["model"]))
    init = reference.InitialPieces(11, "cpu", cell.family.init_rules(cell.config["model"]), table.total)
    for _, path, shape, off, n in table.pieces():
        assert torch.equal(init.get(path, shape, off, n), flat[off:off + n])
    assert not torch.equal(flat, reference.make_flat(table, 12, "cpu", cell.family.init_rules(cell.config["model"])))


@pytest.mark.parametrize("config", layout.names("configs"))
def test_the_ports_layout_is_the_references(config):
    from repro_torch.models import build_model

    workload = {"name": "x", "config": config, "traffic": "train.b4.s2048", "chips": 1}
    cell = layout.load_cell("x", overrides={"workload": workload})
    table = reference.LeafTable(cell.family.leaf_shapes(cell.config["model"]))
    model = build_model(cell.driver.port_config(cell))
    cell.driver.check_program(model, table, cell.config["optimizer"]["z_loss"])
    n = sum(t.numel() for _, t in reference.tree_leaves(model.init(device="meta")))
    assert n == table.total

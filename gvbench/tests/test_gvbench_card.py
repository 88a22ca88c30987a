"""On the card, at each cell's own sizes and load: the program's reading
lies within the cell's limit and the control's (the reference at fp8 in
the program's place) beyond it. Skips without a CUDA card."""

import pytest

from gvbench import harness

BENCH = harness.benchmark()
SEEDS = {"serve.distinct-c8": 70001, "serve.repeat3-c8": 70003}


@pytest.mark.card
@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_control_fails_where_the_program_passes(card, cell):
    import torch

    conf = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    drv = harness.driver(mix["driver"])
    run = drv.ServeRun(conf, mix, SEEDS[cell["name"]], card)
    try:
        run.setup()
        run.window(20.0, False)
        run.free_program()
        r = run.check(control=True)
    finally:
        run.close()
        del run
        torch.cuda.empty_cache()
    limit = harness.limits(cell["name"])["max_logit_gap"]
    assert r["tokens"] >= 100
    assert r["gap"] <= limit < r["control_gap"], r

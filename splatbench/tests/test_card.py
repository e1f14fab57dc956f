"""A short run of the command on the card: the result line's keys, a
correct run and the per-layer metrics of a traced one."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "splatbench.run", "--workload",
         "trained262k.train", "--seed", str(2**31 + 17), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    want = {"train.mfu", "train.k1_roofline", "train.k2_roofline"} if trace \
        else {"train_step_ms", "setup_s"}
    assert want <= set(res["metrics"])

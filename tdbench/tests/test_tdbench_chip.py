"""On the card: one short run of the first cell with its control judged
in the program's place, which must come out not correct while the
program's own readings keep within the limits."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.chip
def test_first_cell_runs_correct_and_its_control_fails(chip):
    out = subprocess.run(
        [sys.executable, "tdbench/run.py", "--workload",
         "dbrx-132b.8of40.td.long_prompt", "--seed", str(2 ** 31 + 5),
         "--seconds", "10", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    info = res["info"]
    limits = {k: c["limit"] for k, c in res["checks"].items()
              if "program_" + k in info}
    assert limits
    assert all(info["program_" + k] <= lim for k, lim in limits.items())
    assert res["correct"] is False
    assert any(res["checks"][k]["value"] > lim for k, lim in limits.items())

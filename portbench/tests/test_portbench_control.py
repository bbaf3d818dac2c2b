"""The controls at a size the CPU holds: the reference with every
product's operands in float8 e4m3 in the program's place reads wider than
the program, in serving (the gap of the token it puts first) and in
training (at least one of the compared numbers), and so does the reference
on half of each batch in training."""

import pytest
import portbench_smoke as smoke

from portbench import run as harness


def _readings(workload, controls, seed):
    plan = smoke.small_plan(workload, "bfloat16")
    if "engine" in plan["mix"]:
        plan["mix"]["engine"]["kv_dtype"] = "bfloat16"
    driver = harness.load_module(harness.HERE / "drivers"
                                 / f"{plan['mix']['driver']}.py")
    env = harness.Env(plan, seed, smoke.SECONDS[workload], False, "cpu")
    env.controls = controls
    out = driver.run(env)
    checks = out["check"]["checks"]
    return {k: v["value"] for k, v in checks.items()}, out["controls"]


@pytest.mark.parametrize("seed", [101, 202])
def test_serving_control_reads_wider(seed):
    program, controls = _readings(smoke.SERVE, ["fp8"], seed)
    assert controls["fp8"]["served_gap"] > 3 * program["served_gap"]


@pytest.mark.parametrize("seed", [101, 202])
def test_training_controls_read_wider(seed):
    program, controls = _readings(smoke.TRAIN, ["fp8", "half_batch"], seed)
    for name in ("fp8", "half_batch"):
        assert any(controls[name][k] > 3 * program[k] for k in program)

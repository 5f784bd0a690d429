"""chip_smoke.py's contract with whoever runs it: it refuses to run
anywhere but a GPU, and its last line is exactly the agreed JSON."""

import json
import types

import jax
import pytest

import chip_smoke


def test_refuses_a_cpu_device():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices())
    assert exc.value.code not in (0, None)


def test_last_line_is_the_contract():
    card = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([card])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(chip_smoke.result_line([card] * 4))["device"]["count"] == 4

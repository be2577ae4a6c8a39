"""`bench.py`'s config table and its refusal to time the CPU."""

import json

import jax
import pytest

import bench
from tendrils.models import configs

# BASELINE.md's configs at their published sizes: (rootNum, view (H, W)).
PUBLISHED = {
    1: (256, (720, 1280)),
    2: (1024, (1080, 1920)),
    3: (2048, (1080, 1920)),
    4: (512, (720, 1280)),
    5: (4096, (2160, 3840)),
}


@pytest.mark.parametrize("config", sorted(PUBLISHED))
def test_config_table_is_published_size(config):
    name, model, _, _ = bench.CONFIGS[config]
    assert name.startswith(f"{config}:")
    assert model in configs.MODELS
    assert bench.config_shape(config) == PUBLISHED[config]


def test_bench_refuses_the_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no accelerator"):
        bench.main([])


def test_line_names_the_device(capsys):
    device = {"platform": "gpu", "kind": "H100", "count": 1}
    bench._line(2, 1 << 20, 0.002, device)
    line = json.loads(capsys.readouterr().out)
    assert line["device"] == device
    assert line["config"] == "2:1M-flow-trail"
    assert line["value"] == round((1 << 20) / 0.002)

"""The port's roofline (``repro_torch.roofline``) against the reference's.

* the ring wire factors equal both reference copies
  (``hlo_cost._wire_factor``, ``hlo_parse._wire_factor``) for every op and
  group size in {1, 2, 4, 16, 256};
* ``model_flops`` / ``model_bytes`` equal the reference's for every arch
  x shape x {256, 512} devices;
* the twin of ``tests/test_distribution.py::
  test_hlo_cost_trip_count_multiplies``: five iterations of an 8 x 8
  float32 product and an all-reduce over 4 fake ranks count 5 x 1024
  FLOPs and 5 x 384 wire bytes, as ``hlo_cost.analyze(SYNTH_HLO, 4)``
  does (the port counts the loop's ops as they run; the fake process
  group runs in a subprocess);
* the recorder's FLOPs, traffic and live bytes on plain tensors, the
  H100 terms of ``analyze_cell``, and the breakdown of an op table.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.roofline import hlo_cost, hlo_parse
from repro.roofline import model as RM
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.roofline import breakdown, counts
from repro_torch.roofline import model as M
from test_distribution import SYNTH_HLO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "send"]


@pytest.mark.parametrize("op", OPS)
def test_wire_factors_equal_reference(op):
    for g in (1, 2, 4, 16, 256):
        for rb in (0, 1, 384, 10 ** 9 + 7):
            got = counts.wire_factor(op, g, rb)
            assert got == hlo_cost._wire_factor(op, g, rb), (op, g, rb)
            assert got == hlo_parse._wire_factor(op, g, rb), (op, g, rb)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_and_bytes_equal_reference(arch, shape):
    for n in (256, 512):
        assert M.model_flops(arch, shape, n) == RM.model_flops(arch, shape, n)
        assert M.model_bytes(arch, shape, n) == RM.model_bytes(arch, shape, n)


LOOP = textwrap.dedent("""\
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.roofline.counts import Recorder
    with fake_world(4):
        x = torch.ones(8, 8)
        rec = Recorder()
        with rec:
            for _ in range(5):
                y = x @ x
                y = funcol.all_reduce(y, "sum", dist.group.WORLD)
                y = funcol.wait_tensor(y)
        c = rec.counts()
    print(json.dumps({"flops": c.flops, "wire": c.wire_bytes_by_op,
                      "count": c.count_by_op, "links": c.wire_bytes_by_link}))
""")


def test_loop_counts_every_iteration_like_hlo_trip_counts():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", LOOP], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    ref = hlo_cost.analyze(SYNTH_HLO, n_devices=4)
    assert got["flops"] == 5 * 1024 == ref.dot_flops
    assert got["wire"]["all-reduce"] == 5 * 384 \
        == ref.wire_bytes_by_op["all-reduce"]
    assert got["count"]["all-reduce"] == 5
    # 4 consecutive ranks sit in one NVLink node
    assert got["links"] == {"nvlink": 5 * 384, "network": 0.0}


def test_recorder_counts_local_ops():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    rec = counts.Recorder()
    rec.exclude([a, b])
    with rec:
        c = a @ b                       # 2*4*8*3 FLOPs; 128 + 96 + 48 bytes
        v = c.view(12)                  # a view moves nothing
        d = v + 1.0                     # 48 + 48 bytes
        del c, v
    got = rec.counts()
    assert got.flops == 2 * 4 * 8 * 3
    assert got.ops["aten.mm"] == [1, 192.0, 272.0]
    assert got.ops["aten.view"][2] == 0.0
    assert got.traffic_bytes == 272.0 + 96.0
    # c and d alive together at the peak; the arguments left out
    assert got.peak_bytes == 96 and rec.live == 48
    del d
    assert rec.live == 0


def _cell(tmp_path, name, **kw) -> str:
    r = {"arch": "gemma3-1b", "shape": "decode_32k", "mesh": "single",
         "status": "ok", "n_devices": 256,
         "memory": {"argument_size_in_bytes": 10 * 2**30,
                    "temp_size_in_bytes": 2**30},
         "cost": {"flops": 989.4e12, "bytes accessed": 2 * 3.35e12},
         "collectives": {"total_wire_bytes": 450e9 + 50e9,
                         "wire_bytes_by_link": {"nvlink": 450e9,
                                                "network": 50e9}}}
    r.update(kw)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(r))
    return str(path)


def test_analyze_cell_h100_terms(tmp_path):
    c = M.analyze_cell(_cell(tmp_path, "a"))
    assert c.fits_80g and abs(c.mem_gib - 11.0) < 1e-12
    assert c.t_compute == 1.0 and c.t_memory == 2.0
    assert c.t_collective == 1.0 + 1.0
    assert c.dominant == "memory"
    big = M.analyze_cell(_cell(tmp_path, "b", memory={
        "argument_size_in_bytes": 80 * 2**30, "temp_size_in_bytes": 1}))
    assert not big.fits_80g
    _cell(tmp_path, "c", status="fail")
    cells = M.analyze_dir(str(tmp_path))
    assert [x.mem_gib > 11 for x in cells] == [False, True]
    table = M.markdown_table(cells)
    assert "fits 80G" in table and table.count("\n") == 3


def test_breakdown_prints_the_op_table(tmp_path, capsys):
    table = {"ops": {"aten.mm": {"count": 2, "flops": 4.0, "bytes": 3e9}},
             "hot": [{"op": "aten.mm", "shape": "(4, 4)", "bytes": 3e9}],
             "collectives": {"all-gather": {"count": 1, "bytes": 2e9,
                                            "wire_bytes": 1e9}}}
    path = tmp_path / "cell.ops.json"
    path.write_text(json.dumps(table))
    breakdown.breakdown(str(path))
    out = capsys.readouterr().out
    assert "aten.mm" in out and "all-gather" in out
    assert "wire=1.00GB" in out

"""The row-sharded layers of spatial partitioning (`parallel/spatial.py`,
`models/layers.py`) on gloo ranks on the CPU, against the whole op in one
process on the same float64 inputs (numpy seed):

- convolutions of kernel 1, 3 and 7, stride 1 and 2, dilation 2, grouped
  and with a bias, the -inf-padded max pool and the nearest x2 upsample,
  on bands even (16 rows over 2 ranks) and uneven (3 over 2: 2 and 1;
  over 4 ranks: 1, 1, 1 and none; 9 over 4: 3, 3, 3 and none), also
  on a 2 data x 2 space mesh: the ranks' output bands put together equal
  the whole op's output, their input gradients (of sum(y * gy), gy drawn
  for the whole output) the whole op's input gradient, and the conv
  parameters' gradients summed over the ranks the whole op's, within
  1e-12 (float64, only the summation order differs);
- BnAct in training mode over 2 x 2 ranks with uneven bands (3 rows:
  2 and 1) against one process on the whole float32 batch: outputs and
  gradients within 1e-5, running statistics within 1e-6;
- the halo sizes: the 7x7 stride-2 stem on 256 rows over 2 ranks takes 3
  rows from above into the lower band and 2 from below into the upper.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_cases as cases
import torch_spatial_cases as spatial_cases
from volume_segmantics_tpu_torch.models.layers import BnAct
from volume_segmantics_tpu_torch.parallel.mesh import band, spawn_ranks
from volume_segmantics_tpu_torch.parallel.spatial import _segments

torch.set_num_threads(cases.THREADS)

F64_TOL = 1e-12
BN_TOL, BN_STATS_TOL = 1e-5, 1e-6

# name: (op, height, kernel, stride, padding, dilation, groups, bias)
OPS = {
    "conv1_s1": ("conv", 1, 1, 0, 1, 1, False),
    "conv1_s2": ("conv", 1, 2, 0, 1, 1, False),
    "conv3_s1": ("conv", 3, 1, 1, 1, 1, True),
    "conv3_s2": ("conv", 3, 2, 1, 1, 1, False),
    "conv7_s2": ("conv", 7, 2, 3, 1, 1, False),
    "conv7_s1": ("conv", 7, 1, 3, 1, 1, False),
    "conv3_dilated": ("conv", 3, 1, 2, 2, 1, False),
    "conv3_grouped": ("conv", 3, 2, 1, 1, 4, False),
    "max_pool": ("max_pool", 3, 2, 1, 1, 1, False),
    "upsample": ("upsample", None, None, None, None, None, False),
}
# (space, data, height) meshes and heights: even, uneven, bands past the end
LAYOUTS = [(2, 1, 16), (2, 1, 3), (4, 1, 3), (4, 1, 9), (2, 2, 5)]
N, C = 2, 4


def case_name(op, layout):
    space, data, height = layout
    return f"{op}-{data}x{space}-h{height}"


def make_case(op, layout, rng):
    kind, k, s, p, d, g, bias = OPS[op]
    space, data, height = layout
    n = N * data
    x = torch.from_numpy(rng.standard_normal((n, C, height, height)))
    case = {"name": case_name(op, layout), "op": kind, "space": space,
            "x": x, "kernel": k, "stride": s, "padding": p, "dilation": d,
            "groups": g, "weight": None, "bias": None}
    if kind == "conv":
        case["weight"] = torch.from_numpy(rng.standard_normal((8, C // g, k, k)))
        if bias:
            case["bias"] = torch.from_numpy(rng.standard_normal(8))
    with torch.no_grad():
        y = whole_op(case, x)
    case["gy"] = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    return case


def whole_op(case, x):
    if case["op"] == "conv":
        return F.conv2d(x, case["weight"], case["bias"], case["stride"],
                        case["padding"], case["dilation"], case["groups"])
    if case["op"] == "max_pool":
        return F.max_pool2d(x, case["kernel"], case["stride"], case["padding"])
    return F.interpolate(x, scale_factor=2, mode="nearest")


ALL = [(op, layout) for layout in LAYOUTS for op in OPS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, over 2 ranks (the 1 x 2 layouts) and over 4 (the 1 x 4
    and 2 x 2 ones), each world spawned once."""
    rng = np.random.default_rng(14)
    made = {case_name(op, layout): make_case(op, layout, rng)
            for op, layout in ALL}
    results = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"primitives{world}")
        chosen = [c for c in made.values()
                  if c["space"] * (c["x"].shape[0] // N) == world]
        spaces = sorted({c["space"] for c in chosen})
        torch.save({"cases": chosen, "spaces": spaces}, tmp / "in.pt")
        spawn_ranks(spatial_cases.primitives_rank, world,
                    args=(str(tmp / "in.pt"), str(tmp)),
                    timeout=cases.TIMEOUT_S)
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        for c in chosen:
            results[c["name"]] = (c, [r[c["name"]] for r in ranks])
    return results


@pytest.mark.parametrize("op,layout", ALL,
                         ids=[case_name(op, layout) for op, layout in ALL])
def test_bands_put_together_are_the_whole_op(runs, op, layout):
    case, ranks = runs[case_name(op, layout)]
    x = case["x"].clone().requires_grad_()
    fn, module = spatial_cases.primitive(case)
    y = fn(x)
    (y * case["gy"]).sum().backward()
    got_y, got_gx = torch.full_like(y, float("nan")), torch.zeros_like(x)
    for r in ranks:
        got_y[r["rows"], :, r["out_band"]] = r["y"]
        got_gx[r["rows"], :, r["band"]] += r["gx"]
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), rtol=0,
                               atol=F64_TOL)
    np.testing.assert_allclose(got_gx.numpy(), x.grad.numpy(), rtol=0,
                               atol=F64_TOL)
    for name, p in (module.named_parameters() if module is not None else ()):
        summed = sum(r["gparams"][name] for r in ranks)
        np.testing.assert_allclose(summed.numpy(), p.grad.numpy(), rtol=0,
                                   atol=F64_TOL, err_msg=name)


def test_uneven_layouts_leave_a_band_short_of_its_halo_or_empty():
    """The layouts above do test what they say: 3 rows over 2 ranks are 2
    and 1 (the 7x7 conv's 3-row halo is longer than the lower band), over
    4 they leave the last band empty."""
    assert [band(3, 2, j) for j in range(2)] == [slice(0, 2), slice(2, 3)]
    assert [band(3, 4, j) for j in range(4)] == [
        slice(0, 1), slice(1, 2), slice(2, 3), slice(3, 3)]
    assert [band(9, 4, j) for j in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 9)]


def test_stem_halo_is_three_rows_above_and_two_below():
    """The 7x7 stride-2 stem (padding 3) on 256 rows over 2 ranks: output
    bands [0, 64) and [64, 128) read input rows [-3, 130) and [125, 258)."""
    needs = [(out * 2 - 3, (out_end - 1) * 2 - 3 + 7)
             for out, out_end in ((0, 64), (64, 128))]
    pieces, total = _segments(256, 2, needs)
    assert pieces[0] == [("pad", 3), ("own", 0, 128), ("buf", 0, 128, 130)]
    assert pieces[1] == [("buf", 2, 125, 128), ("own", 128, 256), ("pad", 2)]
    assert total == 5


@pytest.fixture(scope="module")
def bn_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batchnorm")
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((4, 5, 3, 3)).astype(np.float32))
    x = x * 3.0 + 1.5
    bn = BnAct(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(5)))
    gy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    torch.save({"x": x, "gy": gy, "state": bn.state_dict(), "space": 2},
               tmp / "in.pt")
    spawn_ranks(spatial_cases.batchnorm_rank, 4,
                args=(str(tmp / "in.pt"), str(tmp)), timeout=cases.TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    xg = x.clone().requires_grad_()
    y = bn.train()(xg)
    (y * gy).sum().backward()
    return ranks, bn, y.detach(), xg.grad


def test_batchnorm_over_two_by_two_ranks_is_one_process(bn_run):
    ranks, bn, y, gx = bn_run
    assert [r["mesh"] for r in ranks] == [(0, 0, 2, 2), (0, 1, 2, 2),
                                          (1, 0, 2, 2), (1, 1, 2, 2)]
    assert [r["band"] for r in ranks[:2]] == [slice(0, 2), slice(2, 3)]
    got_y, got_gx = torch.full_like(y, float("nan")), torch.zeros_like(gx)
    for r in ranks:
        got_y[r["rows"], :, r["band"]] = r["y"]
        got_gx[r["rows"], :, r["band"]] = r["gx"]
        for name, value in r["stats"].items():
            np.testing.assert_allclose(value.numpy(),
                                       bn.state_dict()[name].numpy(),
                                       rtol=0, atol=BN_STATS_TOL, err_msg=name)
    np.testing.assert_allclose(got_y.numpy(), y.numpy(), rtol=0, atol=BN_TOL)
    np.testing.assert_allclose(got_gx.numpy(), gx.numpy(), rtol=0, atol=BN_TOL)
    for name, p in bn.named_parameters():
        summed = sum(r["gparams"][name] for r in ranks)
        np.testing.assert_allclose(summed.numpy(), p.grad.numpy(), rtol=0,
                                   atol=BN_TOL, err_msg=name)

"""The row-sharded layers that the decoders and encoders beside U-Net
need under spatial partitioning (`parallel/spatial.py`, `models/layers.py`)
on gloo ranks on the CPU, against the same layer in one process on the
whole float64 input (numpy seed), in training mode:

- LinkNet's transposed conv (4, 2, 1), EfficientNet's TF-"SAME" convs
  (depthwise; kernel 3 and 5, stride 1 and 2, dilation 2), FPN's
  GroupNorm, the global mean, ResNeSt's average pools (padding counted;
  2 x 2 with a floor), the align-corners resize at x4, x8 and PAN's odd
  ratios (up to 2H + 1, down to H // 2, from one row), the head's
  half-pixel resize (`layers.resize_to`: antialiased shrinking by a few
  rows, as the head takes ceil(side / up) * up back to the side, and by
  over 3, and growing to 2H + 1) against `F.interpolate`, PAN's 2 x 2 pool
  (its input kept where the global side is below 2), DeepLab's
  dilation-36 3x3 on a 16-row map, and elementwise and channelwise
  Dropout under one seeded generator, on bands even (16 rows over 2
  ranks), uneven (3 over 2: 2 and 1; 5 over 3: 2, 2 and 1), short of
  their halo or empty (2 rows over 3: 1, 1 and none; 1 over 2), also on
  a 2 data x 2 space mesh: the ranks' output bands put together equal the
  whole op's output, their input gradients (of sum(y * gy), gy drawn for
  the whole output) the whole op's input gradient, and the parameters'
  gradients summed over the ranks the whole op's, within 1e-12 (float64,
  only the summation order differs); the Dropout outputs equal;
- a 1x1 Conv2d and a BnAct on the pooled (N, C, 1, 1) value, which every
  rank of a space group holds whole (`layers.Pooled`), 8 samples a data
  row (BatchNorm over 2 would amplify rounding without bound): outputs
  and gradients within 1e-5, running statistics within 1e-6 of one
  process's (BnAct computes in float32), on 1 x 2, 1 x 3 and 2 x 2
  meshes (where the value is summed once a space rank and must be
  counted once);
- the input rows `matrix_support` gives cover every column that the
  align-corners and half-pixel matrices weigh, with at most one row of
  margin, for every band of every size up to 40;
- the half-pixel matrix (`layers._half_pixel_matrix`) against
  `F.interpolate(antialias=True)` of an identity in float64, and against
  the JAX package's matrix (`jax.image.resize` of an identity, as its
  `resize_to` builds it) within 1e-5 in float32, shrinking and growing.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_cases as cases
import torch_spatial_cases as spatial_cases
from volume_segmantics_tpu_torch.models.layers import (
    _align_corners_matrix,
    _half_pixel_matrix,
)
from volume_segmantics_tpu_torch.parallel.mesh import band, spawn_ranks
from volume_segmantics_tpu_torch.parallel.spatial import matrix_support

torch.set_num_threads(cases.THREADS)

F64_TOL = 1e-12
F32_TOL, STATS_TOL = 1e-5, 1e-6
N, C = 2, 4
POOLED_N = 8

# name: (op, args); resize args are the output side as a function of H
OPS = {
    "conv_transpose": ("conv_transpose", None),
    "same_conv3_s1": ("same_conv", (3, 1, 1)),
    "same_conv3_s2": ("same_conv", (3, 2, 1)),
    "same_conv5_s2": ("same_conv", (5, 2, 1)),
    "same_conv5_dilated": ("same_conv", (5, 1, 2)),
    "group_norm": ("group_norm", None),
    "mean": ("mean", None),
    "avg_pool_counted": ("avg_pool", (3, 2, 1)),
    "avg_pool_floor": ("avg_pool_floor", None),
    "resize_x4": ("resize", lambda h: 4 * h),
    "resize_x8": ("resize", lambda h: 8 * h),
    "resize_odd_up": ("resize", lambda h: 2 * h + 1),
    "resize_down": ("resize", lambda h: max(h // 2, 2)),
    "half_resize_head": ("half_resize", lambda h: max(h - max(h // 8, 1), 1)),
    "half_resize_down": ("half_resize", lambda h: max(h // 3, 1)),
    "half_resize_up": ("half_resize", lambda h: 2 * h + 1),
    "pool2": ("pool2", None),
    "dropout": ("dropout", (0.5, False)),
    "dropout_channelwise": ("dropout", (0.2, True)),
    "pooled_conv_bn": ("pooled", None),
}
WHOLE_OUTPUT = ("mean", "pooled")
# (space, data, height): even, uneven, short of a halo or empty, one row
LAYOUTS = [(2, 1, 16), (2, 1, 3), (3, 1, 5), (3, 1, 2), (2, 1, 1), (2, 2, 5)]


def case_name(op, layout):
    space, data, height = layout
    return f"{op}-{data}x{space}-h{height}"


def all_cases():
    chosen = [(op, layout) for layout in LAYOUTS for op in OPS
              if not (op == "avg_pool_floor" and layout[2] == 1)]
    # DeepLab's ASPP at rate 36 on the 16-row stride-16 map of 256^2: the
    # halo spans every other band and runs past both edges.
    return chosen + [("aspp_rate36", (2, 1, 16)), ("aspp_rate36", (3, 1, 16))]


def make_case(op, layout, rng, seed):
    space, data, height = layout
    kind, args = ("conv", (3, 36)) if op == "aspp_rate36" else OPS[op]
    if kind in ("resize", "half_resize"):
        args = args(height)
    n = POOLED_N if kind == "pooled" else N
    x = torch.from_numpy(rng.standard_normal((n * data, C, height, height)))
    case = {"name": case_name(op, layout), "op": kind, "args": args,
            "space": space, "x": x, "channels": C, "seed": seed,
            "whole_output": kind in WHOLE_OUTPUT}
    with torch.no_grad():
        y = whole_op(case, x)
    case["gy"] = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    return case


def whole_op(case, x):
    fn, _ = spatial_cases.op_layer(case)
    if isinstance(fn, torch.nn.Module):
        spatial_cases.prepare_layer(fn, case)
    return fn(x)


ALL = all_cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, over 2 ranks (the 1 x 2 layouts), 3 (1 x 3) and 4
    (2 x 2), each world spawned once."""
    rng = np.random.default_rng(15)
    made = {case_name(op, layout): make_case(op, layout, rng, seed)
            for seed, (op, layout) in enumerate(ALL)}
    results = {}
    for world in (2, 3, 4):
        tmp = tmp_path_factory.mktemp(f"ops{world}")
        chosen = [c for c in made.values() if world == c["space"] * (
            c["x"].shape[0] // (POOLED_N if c["op"] == "pooled" else N))]
        spaces = sorted({c["space"] for c in chosen})
        torch.save({"cases": chosen, "spaces": spaces}, tmp / "in.pt")
        spawn_ranks(spatial_cases.ops_rank, world,
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
    fn, module = spatial_cases.op_layer(case)
    if isinstance(fn, torch.nn.Module):
        spatial_cases.prepare_layer(fn, case)
    y = fn(x)
    (y * case["gy"]).sum().backward()
    tol = F32_TOL if case["op"] == "pooled" else F64_TOL
    got_y, got_gx = torch.full_like(y, float("nan")), torch.zeros_like(x)
    for r in ranks:
        if case["whole_output"]:
            np.testing.assert_allclose(r["y"].numpy(), y[r["rows"]].detach().numpy(),
                                       rtol=0, atol=tol)
        got_y[r["rows"], :, r["out_band"]] = r["y"]
        got_gx[r["rows"], :, r["band"]] += r["gx"]
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), rtol=0,
                               atol=0 if case["op"] == "dropout" else tol)
    np.testing.assert_allclose(got_gx.numpy(), x.grad.numpy(), rtol=0, atol=tol)
    for name, p in (module.named_parameters() if module is not None else ()):
        summed = sum(r["gparams"][name] for r in ranks)
        np.testing.assert_allclose(summed.numpy(), p.grad.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    for name, value in (module.state_dict().items() if module is not None else ()):
        if name.endswith(("running_mean", "running_var")):
            for r in ranks:
                np.testing.assert_allclose(r["stats"][name].numpy(),
                                           value.numpy(), rtol=0,
                                           atol=STATS_TOL, err_msg=name)


def test_layouts_leave_bands_short_of_their_halo_or_empty():
    """5 rows over 3 ranks are 2, 2 and 1; 2 rows over 3 leave the last
    band empty, and 1 row over 2 the second; the dilation-36 conv's
    36-row halo spans every band of a 16-row map."""
    assert [band(5, 3, j) for j in range(3)] == [
        slice(0, 2), slice(2, 4), slice(4, 5)]
    assert [band(2, 3, j) for j in range(3)] == [
        slice(0, 1), slice(1, 2), slice(2, 2)]
    assert [band(1, 2, j) for j in range(2)] == [slice(0, 1), slice(1, 1)]


def assert_support_covers(matrix, parts):
    out_len, in_len = matrix.shape
    needs = matrix_support(matrix, parts)
    for j in range(parts):
        out = band(out_len, parts, j)
        if out.start == out.stop:
            assert needs[j] == (in_len, in_len + 1)
            continue
        lo, hi = needs[j]
        used = torch.nonzero(matrix[out].abs().sum(0)).flatten()
        first, last = used.min().item(), used.max().item()
        assert lo <= first and last < hi, (in_len, out_len, j, lo, hi, used)
        assert first - lo <= 1 and hi - 1 - last <= 1, (lo, hi, used)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_align_corners_support_covers_the_weighed_rows(parts):
    for in_len in range(1, 41):
        for out_len in range(1, 41):
            if out_len == 1 and in_len > 1:
                continue  # the matrix is undefined there (0 / 0)
            assert_support_covers(_align_corners_matrix(
                out_len, in_len, torch.device("cpu"), torch.float32), parts)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_half_pixel_support_covers_the_weighed_rows(parts):
    for in_len in range(1, 41):
        for out_len in range(1, 41):
            assert_support_covers(_half_pixel_matrix(
                out_len, in_len, torch.device("cpu"), torch.float32), parts)


# JAX computes its kernel's taps in float32: up to 4.0e-6 from the float64
# weights at 64 -> 60.
JAX_MATRIX_TOL = 1e-5
# (out, in): the head's shrinks (DeepLabV3 at 60 and 68, FPN and PAN at 62
# and 66), a shrink by over 3, to one row, and growth.
HALF_PIXEL_SIZES = [(60, 64), (68, 72), (62, 64), (66, 68), (5, 16), (1, 7),
                    (33, 16), (16, 15), (7, 1)]


@pytest.mark.parametrize("out_len,in_len", HALF_PIXEL_SIZES)
def test_half_pixel_matrix_is_interpolate_and_jax_resize(out_len, in_len):
    import jax
    import jax.numpy as jnp

    ours = _half_pixel_matrix(out_len, in_len, torch.device("cpu"),
                              torch.float64)
    eye = torch.eye(in_len, dtype=torch.float64)[None, None]
    ref = F.interpolate(eye, size=(out_len, in_len), mode="bilinear",
                        align_corners=False, antialias=True)[0, 0]
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-14)
    if out_len > in_len:  # growing, the antialias changes nothing
        plain = F.interpolate(eye, size=(out_len, in_len), mode="bilinear",
                              align_corners=False)[0, 0]
        np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=0,
                                   atol=1e-14)
    jax_matrix = jax.image.resize(jnp.eye(in_len, dtype=jnp.float32),
                                  (out_len, in_len), method="bilinear")
    np.testing.assert_allclose(
        _half_pixel_matrix(out_len, in_len, torch.device("cpu"),
                           torch.float32).numpy(),
        np.asarray(jax_matrix), rtol=0, atol=JAX_MATRIX_TOL)

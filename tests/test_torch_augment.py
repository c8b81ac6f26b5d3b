"""The PyTorch augmentation stages against the JAX package's, given the
values JAX drew: the test recomputes each draw from the same keys with the
few `jax.random` calls of `ops/augment.py` and hands them to the port's
apply steps. Coordinates within 1e-5 (float32 fields of magnitude < 64,
where one ulp is <= 3.8e-6), intensities within 1e-6. The port's own draws
are checked by frequency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.ops import augment as jaug
from volume_segmantics_tpu.ops.warp import identity_coords as jax_identity
from volume_segmantics_tpu_torch.ops import augment as aug

torch.set_num_threads(1)

S = 32
COORD_ATOL = 1e-5
INTENSITY_ATOL = 1e-6
KEYS = jax.random.split(jax.random.PRNGKey(3), 6)


def _np(x):
    return np.asarray(x)


def jax_geometric_draws(key, size):
    """The draws `_geometric_coords(key, size)` makes, in the port's
    parameter layout (one sample)."""
    keys = jax.random.split(key, 10)
    k_branch, k_e, k_g, k_o = jax.random.split(keys[1], 4)
    k_dx, k_dy, k_aff = jax.random.split(k_e, 3)
    small = size // 4
    noise = [jax.random.uniform(k, (small, small), minval=-1.0, maxval=1.0)
             for k in (k_dx, k_dy)]
    lim = jaug.GRID_DISTORT_LIMIT
    cells = jaug.grid_cell_count(size)
    factors = [1.0 + jax.random.uniform(k, (cells,), minval=-lim, maxval=lim)
               for k in jax.random.split(k_g)]
    k_k, k_odx, k_ody = jax.random.split(k_o, 3)
    shift = jaug.OPTICAL_SHIFT_LIMIT
    k_side, k_y, k_x = jax.random.split(keys[8], 3)
    p = {
        "do_distort": jax.random.bernoulli(keys[0], 0.5),
        "branch": jax.random.randint(k_branch, (), 0, 3),
        "elastic_noise": jnp.stack(noise),
        "elastic_affine": jax.random.uniform(
            k_aff, (3, 2), minval=-jaug.ELASTIC_ALPHA_AFFINE,
            maxval=jaug.ELASTIC_ALPHA_AFFINE),
        "grid_factors": jnp.stack(factors),
        "optical_k": jax.random.uniform(
            k_k, (), minval=-jaug.OPTICAL_DISTORT_LIMIT,
            maxval=jaug.OPTICAL_DISTORT_LIMIT),
        "optical_dx": jnp.round(jax.random.uniform(
            k_odx, (), minval=-shift, maxval=shift)),
        "optical_dy": jnp.round(jax.random.uniform(
            k_ody, (), minval=-shift, maxval=shift)),
        "do_transpose": jax.random.bernoulli(keys[3], 0.5),
        "do_rot": jax.random.bernoulli(keys[4], 0.5),
        "rot_k": jax.random.randint(keys[5], (), 0, 4),
        "do_flip": jax.random.bernoulli(keys[6], 0.5),
        "do_crop": jax.random.bernoulli(keys[7], 0.5),
        "crop_side": jax.random.randint(k_side, (), size // 2, size + 1),
        "crop_h_start": jax.random.uniform(k_y, ()),
        "crop_w_start": jax.random.uniform(k_x, ()),
    }
    return p, (k_e, k_g, k_o)


def batch_draws(keys, size):
    draws = [jax_geometric_draws(k, size)[0] for k in keys]
    return {
        name: torch.from_numpy(np.stack([_np(d[name]) for d in draws]))
        for name in draws[0]
    }


@pytest.fixture(scope="module")
def draws():
    return batch_draws(KEYS, S)


def test_optical_field(draws):
    coords = jax_identity(S, S)
    got = aug.optical_field(draws["optical_k"], draws["optical_dx"],
                            draws["optical_dy"], aug.identity_coords(S, S), S)
    for i in range(len(KEYS)):
        ref = jaug.optical_field(
            jnp.float32(draws["optical_k"][i]), jnp.float32(draws["optical_dx"][i]),
            jnp.float32(draws["optical_dy"][i]), coords, S)
        np.testing.assert_allclose(got[i].numpy(), _np(ref), atol=COORD_ATOL, rtol=0)


def test_grid_axis_map_and_grid_coords(draws):
    axis = np.arange(S, dtype=np.float32)
    got_axis = aug.grid_axis_map(draws["grid_factors"][:, 0],
                                 torch.from_numpy(axis), S)
    got = aug.grid_coords(draws["grid_factors"], S)
    for i, key in enumerate(KEYS):
        ref_axis = jaug.grid_axis_map(jnp.asarray(draws["grid_factors"][i, 0]),
                                      jnp.asarray(axis), S)
        np.testing.assert_allclose(got_axis[i].numpy(), _np(ref_axis),
                                   atol=COORD_ATOL, rtol=0)
        _, (_, k_g, _) = jax_geometric_draws(key, S)
        ref = jaug._grid_coords(k_g, jax_identity(S, S), S)
        np.testing.assert_allclose(got[i].numpy(), _np(ref), atol=COORD_ATOL, rtol=0)


def test_elastic_coords_with_given_noise(draws):
    got = aug.elastic_coords(draws["elastic_noise"], draws["elastic_affine"],
                             aug.identity_coords(S, S), S)
    for i, key in enumerate(KEYS):
        _, (k_e, _, _) = jax_geometric_draws(key, S)
        ref = jaug._elastic_coords(k_e, jax_identity(S, S), S)
        np.testing.assert_allclose(got[i].numpy(), _np(ref), atol=COORD_ATOL, rtol=0)


def test_smooth_noise_field_matches_jax():
    noise = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16)).astype(np.float32)
    got = aug.smooth_noise_field(torch.from_numpy(noise), 64)
    blur = jax.vmap(lambda n: jax.image.resize(
        jnp.eye(16), (64, 16), method="bilinear"
    ) @ (jaug.gaussian_blur_2d(n, jaug.ELASTIC_SIGMA / 4) / 4) @ jax.image.resize(
        jnp.eye(16), (64, 16), method="bilinear").T)(jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), _np(blur), atol=1e-7, rtol=0)


def test_post_distortion_affine_and_geometric_coords(draws):
    M, b = aug.post_distortion_affine(draws, S)
    got = aug.geometric_coords(draws, S)
    for i, key in enumerate(KEYS):
        ref_m, ref_b = jaug._post_distortion_affine(jax.random.split(key, 10), S)
        np.testing.assert_allclose(M[i].numpy(), _np(ref_m), atol=1e-7, rtol=0)
        np.testing.assert_allclose(b[i].numpy(), _np(ref_b), atol=COORD_ATOL, rtol=0)
        ref = jaug._geometric_coords(key, S)
        np.testing.assert_allclose(got[i].numpy(), _np(ref), atol=COORD_ATOL, rtol=0)


def test_geometric_coords_every_branch():
    """Force each distortion branch and every affine stage on, so the
    comparison covers the paths a random draw may miss."""
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    p = batch_draws(keys, S)
    for branch in range(3):
        forced = dict(p, do_distort=torch.ones(3, dtype=torch.bool),
                      branch=torch.full((3,), branch))
        for k in ("do_transpose", "do_rot", "do_flip", "do_crop"):
            forced[k] = torch.ones(3, dtype=torch.bool)
        got = aug.geometric_coords(forced, S)
        for i, key in enumerate(keys):
            _, (k_e, k_g, k_o) = jax_geometric_draws(key, S)
            ident = jax_identity(S, S)
            field = (jaug._elastic_coords(k_e, ident, S), jaug._grid_coords(k_g, ident, S),
                     jaug._optical_coords(k_o, ident, S))[branch]
            m, b = aug.post_distortion_affine(forced, S)
            m, b = jnp.asarray(m[i].numpy()), jnp.asarray(b[i].numpy())
            ref = jnp.stack([m[0, 0] * field[0] + m[0, 1] * field[1] + b[0],
                             m[1, 0] * field[0] + m[1, 1] * field[1] + b[1]])
            np.testing.assert_allclose(got[i].numpy(), _np(ref), atol=COORD_ATOL,
                                       rtol=0)


def test_apply_bc_gamma_with_jax_draws():
    rng = np.random.default_rng(4)
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    imgs = rng.random((16, 32, 32)).astype(np.float32)
    imgs[:, 0, :4] = [0.0, 1.0, 1e-9, 0.5]
    drawn = jax.vmap(jaug._intensity_params)(keys)
    names = ("do_clahe", "clip", "do_bcg", "branch", "alpha", "beta", "gamma")
    p = {n: torch.from_numpy(np.array(v)) for n, v in zip(names, drawn)}
    got = aug.apply_bc_gamma(p, torch.from_numpy(imgs)).numpy()
    ref = jax.vmap(jaug._apply_bc_gamma)(*drawn[2:], jnp.asarray(imgs))
    np.testing.assert_allclose(got, _np(ref), atol=INTENSITY_ATOL, rtol=0)


N_FREQ = 4000


@pytest.fixture(scope="module")
def port_draws():
    g = torch.Generator().manual_seed(0)
    return (aug.draw_geometric_params(g, N_FREQ, 32),
            aug.draw_intensity_params(g, N_FREQ))


@pytest.mark.parametrize("name", ["do_distort", "do_transpose", "do_rot",
                                  "do_flip", "do_crop", "do_clahe", "do_bcg"])
def test_each_p_half_op_fires_half_the_time(port_draws, name):
    p = {**port_draws[0], **port_draws[1]}
    assert abs(p[name].float().mean().item() - 0.5) < 0.03


@pytest.mark.parametrize("name,k", [("branch", 3), ("rot_k", 4)])
def test_oneof_branches_are_uniform(port_draws, name, k):
    counts = torch.bincount(port_draws[0][name], minlength=k).float() / N_FREQ
    assert counts.numel() == k
    assert (counts - 1.0 / k).abs().max().item() < 0.03


def test_intensity_oneof_and_ranges(port_draws):
    geo, p = port_draws
    counts = torch.bincount(p["branch"], minlength=2).float() / N_FREQ
    assert (counts - 0.5).abs().max().item() < 0.03
    for name, (lo, hi) in (("clip", (1.0, 4.0)), ("alpha", (0.8, 1.2)),
                           ("beta", (-0.2, 0.2)), ("gamma", (0.8, 1.2))):
        assert lo <= p[name].min().item() and p[name].max().item() <= hi
    assert set(geo["optical_dx"].unique().tolist()) <= {-0.0, 0.0}
    assert geo["crop_side"].min().item() >= 16 and geo["crop_side"].max().item() <= 32


def test_augment_batch_is_seeded_and_well_formed():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 64, 64), dtype=np.uint8))
    msks = torch.from_numpy(rng.integers(0, 3, (4, 64, 64), dtype=np.uint8))
    run = lambda seed: aug.augment_batch_u8(
        torch.Generator().manual_seed(seed), imgs, msks, 64)
    (a_img, a_msk), (b_img, b_msk) = run(1), run(1)
    assert torch.equal(a_img, b_img) and torch.equal(a_msk, b_msk)
    assert a_img.dtype == torch.float32 and a_msk.dtype == torch.uint8
    assert a_img.shape == (4, 64, 64) and a_msk.shape == (4, 64, 64)
    assert 0.0 <= a_img.min().item() and a_img.max().item() <= 1.0
    assert set(a_msk.unique().tolist()) <= {0, 1, 2}

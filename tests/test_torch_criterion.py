"""The port's matcher and criterion against the JAX package's.

Random predictions (numpy seed) and the targets of
`tests/test_criterion.py::make_targets` -- once as built, once with contacts
and a frame whose right hand is invalid, so the gates, masks and contact
terms all do work -- go through `arctic_criterion` of both packages.

Tolerances: assignments identical, ties included (both break them by the
first argmin). Loss terms 1e-4 relative (ROADMAP "Tolerances": float32
arithmetic in another order). Gradients with respect to the predictions
1e-4 of each tensor's max.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.losses import criterion as jcrit
from uvhand_tpu.losses import matching as jmatch
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.losses import criterion, matching

from test_criterion import IMG_RES, make_targets

L, B, Q, C, S = 2, 2, 10, 14, 20


def random_outputs(rng):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    cam = lambda: np.concatenate([0.8 + 0.1 * n(L, B, Q, 1), 0.05 * n(L, B, Q, 2)], -1)
    stacked = {
        "pred_logits": 2.0 * n(L, B, Q, C),
        "pred_hand_key": rng.uniform(-1, 1, (L, B, Q, 42)).astype(np.float32),
        "pred_obj_key": rng.uniform(-1, 1, (L, B, Q, 42)).astype(np.float32),
        "pred_mano_pose": 0.3 * n(L, B, Q, 48),
        "pred_mano_beta": 0.5 * n(L, B, Q, 10),
        "pred_hand_cam": cam(),
        "pred_obj_cam": cam(),
        "pred_obj_rot": 0.3 * n(L, B, Q, 3),
        "pred_obj_rad": np.abs(0.4 * n(L, B, Q, 1)),
    }
    interm = {
        "pred_logits": 2.0 * n(B, S, C),
        "pred_hand_key": rng.uniform(-1, 1, (B, S, 42)).astype(np.float32),
        "pred_obj_key": rng.uniform(-1, 1, (B, S, 42)).astype(np.float32),
    }
    return {"stacked": stacked, "interm_outputs": interm}


@pytest.fixture(scope="module")
def worlds():
    jw = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False),
          jobjects.synthetic_object_bank(2))
    tw = (mano.synthetic_mano(0, True, device="cpu"), mano.synthetic_mano(1, False, device="cpu"),
          objects.synthetic_object_bank(2, device="cpu"))
    return jw, tw


@pytest.fixture(scope="module")
def jax_loss(worlds):
    """The JAX criterion and its gradients, jitted once for both variants."""
    jw = worlds[0]

    @jax.jit
    def loss(stacked, interm, tg):
        def f(st):
            return jcrit.arctic_criterion({"stacked": st, "interm_outputs": interm}, tg, *jw,
                                          img_res=IMG_RES)
        (_, ld), grads = jax.value_and_grad(f, has_aux=True)(stacked)
        return ld, grads

    return loss


def targets_variant(variant, jw):
    rng = np.random.default_rng(3)
    t = {k: np.asarray(v) for k, v in make_targets(rng, *jw)[0].items()}
    if variant == "contacts_partial":
        # contacts within 3 mm for some hand vertices, and frame 1's right
        # hand invalid
        for side in ("ro", "lo"):
            t[f"dist.{side}"] = rng.uniform(0.0, 6e-3, t[f"dist.{side}"].shape).astype(np.float32)
            t[f"idx.{side}"] = rng.integers(0, 300, t[f"idx.{side}"].shape).astype(np.int32)
        t["right_valid"] = np.array([1.0, 0.0], np.float32)
        t["joints_valid_r"] = np.repeat(t["right_valid"][:, None], 21, 1)
        t["target_valid"] = np.array([[True, True, True], [True, True, False]])
    return t


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("variant", ["as_built", "contacts_partial"])
def test_criterion_and_its_gradients_match_jax(worlds, jax_loss, variant):
    jw, tw = worlds
    targets = targets_variant(variant, jw)
    outputs = random_outputs(np.random.default_rng(11))
    jld, jgrads = jax_loss(outputs["stacked"], outputs["interm_outputs"],
                           {k: jnp.asarray(v) for k, v in targets.items()})

    out = to_torch(outputs)
    for v in out["stacked"].values():
        v.requires_grad_()
    total, ld = criterion.arctic_criterion(out, to_torch(targets), *tw, img_res=IMG_RES)
    total.backward()

    assert set(ld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(float(ld[k].detach()), float(jld[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if variant == "contacts_partial":
        assert float(ld["loss/cd"].detach()) > 0
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(out["stacked"][k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-12), err_msg=k)


def test_matcher_assignments_match_jax():
    rng = np.random.default_rng(5)
    b = 6
    logits = 2.0 * rng.standard_normal((b, Q, C)).astype(np.float32)
    hk = rng.uniform(-1, 1, (b, Q, 42)).astype(np.float32)
    ok = rng.uniform(-1, 1, (b, Q, 42)).astype(np.float32)
    # a duplicated query: two candidates with exactly equal cost
    for x in (logits, hk, ok):
        x[:, 7] = x[:, 2]
    labels = np.array([[12, 13, 3]] * b, np.int32)
    labels[1, 2] = 12
    kps = rng.uniform(-1, 1, (b, 3, 42)).astype(np.float32)
    kps[2, 0] = hk[2, 2]  # target 0 of image 2 sits on the duplicated query
    valid = rng.uniform(size=(b, 3)) > 0.2
    ref = np.asarray(jmatch.arctic_match(logits, hk, ok, labels, kps, valid))
    ours = matching.arctic_match(*map(torch.from_numpy, (logits, hk, ok, labels, kps, valid)))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("kind", ["all_equal", "integer_ties", "random"])
def test_hungarian_small_matches_jax_with_ties(kind):
    rng = np.random.default_rng(9)
    b, q, t = 8, 6, 3
    cost = {"all_equal": np.zeros((b, q, t)),
            "integer_ties": rng.integers(0, 3, (b, q, t)),
            "random": rng.standard_normal((b, q, t))}[kind].astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 0] = valid[2, 2] = False
    ref = np.asarray(jax.vmap(jmatch.hungarian_small)(jnp.asarray(cost), jnp.asarray(valid)))
    ours = matching.hungarian_small(torch.from_numpy(cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # each valid target has its own query, and the total is the brute-force optimum
    for i in range(b):
        picks = ours[i][valid[i]].tolist()
        assert len(set(picks)) == len(picks)
        best = min(sum(cost[i, qs[j], j] for j in range(t) if valid[i, j])
                   for qs in np.ndindex(*(q,) * t)
                   if len({qs[j] for j in range(t) if valid[i, j]}) == int(valid[i].sum()))
        got = sum(cost[i, ours[i, j], j] for j in range(t) if valid[i, j])
        assert got == pytest.approx(best, abs=1e-6)

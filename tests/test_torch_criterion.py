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
from uvhand_tpu_torch.geometry import camera, mano, objects
from uvhand_tpu_torch.losses import criterion, matching

from test_criterion import IMG_RES, make_targets

L, B, Q, C, S = 2, 2, 10, 14, 20


def random_outputs(rng, L=L, B=B):
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


# ------------------------------------------- the decoder layers in one batch
#
# `arctic_criterion` runs the per-layer losses once, on the layers folded into
# the batch. Here it is held against a plain loop over the layers built from
# the single-layer pieces (`compute_small_loss` on one layer's selected
# queries, `loss_labels`, `loss_keypoints`, one match per layer), at 6 layers
# of 3 images: every term to 1e-6 relative, the gradients to 1e-5 of each
# tensor's max (float32 sums in another order).

FL, FB = 6, 3


@pytest.fixture(scope="module")
def port_world():
    return (mano.synthetic_mano(0, True, device="cpu"), mano.synthetic_mano(1, False, device="cpu"),
            objects.synthetic_object_bank(2, device="cpu"))


def fold_targets(world, variant="contacts_partial"):
    """Targets of FB images from the port's own FK, with the contacts_partial
    mix: contacts within 3 mm, image 1's right hand and one target slot of
    images 1 and 2 invalid, four of one left hand's joints invalid.
    `right_gate_closed` also drops every right hand (the gate on
    sum(is_valid * right_valid) closes) and image 2's frame."""
    mano_r, mano_l, bank = world
    rng = np.random.default_rng(3)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    n = lambda *s: f(rng.standard_normal(s))
    K = camera.weak_perspective_intrinsics(1000.0, 224)[None].repeat(FB, 1, 1)

    def cam_t(wp):
        return camera.weak_perspective_to_perspective(wp, 1000.0, IMG_RES)[:, None]

    wp_r = torch.stack([torch.full((FB,), 0.8), 0.05 * n(FB), 0.05 * n(FB)], -1)
    wp = {"r": wp_r, "l": wp_r + 0.05, "o": wp_r - 0.03}
    t = {"intrinsics": K, "query_idx": torch.tensor([2, 4, 7], dtype=torch.int32)}
    for side, model in (("r", mano_r), ("l", mano_l)):
        pose, beta = 0.2 * n(FB, 48), 0.5 * n(FB, 10)
        j3d = mano.mano_forward(model, pose[:, :3], pose[:, 3:], beta)[1] + cam_t(wp[side])
        t.update({f"mano.pose.{side}": pose, f"mano.beta.{side}": beta,
                  f"mano.j3d.cam.{side}": j3d, f"mano.cam_t.wp.{side}": wp[side],
                  f"mano.j2d.norm.{side}": camera.normalize_kp2d(camera.project2d(K, j3d),
                                                                 IMG_RES)})
    rot, rad = 0.3 * n(FB, 3), (0.4 * n(FB)).abs()
    kp3d = objects.object_forward(bank, rad, rot, t["query_idx"])["kp3d"] + cam_t(wp["o"])
    t.update({"object.rot": rot, "object.radian": rad, "object.cam_t.wp": wp["o"],
              "object.kp3d.cam": kp3d,
              "object.kp2d.norm": camera.normalize_kp2d(camera.project2d(K, kp3d), IMG_RES)})
    for side in ("ro", "lo"):
        t[f"dist.{side}"] = f(rng.uniform(0.0, 6e-3, (FB, 778)))
        t[f"idx.{side}"] = torch.from_numpy(rng.integers(0, 256, (FB, 778)).astype(np.int32))
    t["labels"] = torch.tensor([[12, 13, 3], [12, 13, 5], [12, 13, 9]], dtype=torch.int32)
    t["keypoints"] = f(rng.uniform(-1, 1, (FB, 3, 42)))
    t["target_valid"] = torch.tensor([[True, True, True], [True, True, False],
                                      [True, False, True]])
    t["is_valid"], t["left_valid"] = torch.ones(FB), torch.ones(FB)
    t["right_valid"] = torch.tensor([1.0, 0.0, 1.0])
    if variant == "right_gate_closed":
        t["right_valid"], t["is_valid"] = torch.zeros(FB), torch.tensor([1.0, 1.0, 0.0])
    t["joints_valid_r"] = t["right_valid"][:, None].repeat(1, 21)
    t["joints_valid_l"] = torch.ones(FB, 21)
    t["joints_valid_l"][0, 5:9] = 0.0
    return t


def fold_outputs(two_stage=True):
    """Random outputs of FL layers; each layer's object queries of its last
    image and of the next layer's first image sit far apart, so a smoothing
    difference taken across a layer boundary would change the result."""
    out = to_torch(random_outputs(np.random.default_rng(13), FL, FB))["stacked"]
    shift = 0.05 * (torch.arange(FL, dtype=torch.float32) + 1.0)
    out["pred_obj_cam"][:, -1, :, 1] += shift[:, None]
    out["pred_obj_cam"][:, 0, :, 1] -= shift[:, None]
    if not two_stage:
        out["pred_hand_key"] = out["pred_obj_key"] = None
    for v in out.values():
        if v is not None:
            v.requires_grad_()
    return {"stacked": out}


def per_layer_loop(outputs, targets, world):
    """The plain loop over the decoder layers: (total, loss dict)."""
    st = outputs["stacked"]
    tgt_valid = targets["target_valid"] & (targets["is_valid"][:, None] > 0)
    num_boxes = targets["target_valid"].sum().float().clamp(min=1.0)
    total, ld = 0.0, {}
    for lvl in range(FL):
        layer = {k: None if v is None else v[lvl] for k, v in st.items()}
        assign = matching.arctic_match(layer["pred_logits"], layer["pred_hand_key"],
                                       layer["pred_obj_key"], targets["labels"],
                                       targets["keypoints"], tgt_valid)
        terms = {"loss_ce": criterion.loss_labels(layer["pred_logits"], targets["labels"],
                                                  assign, tgt_valid, num_boxes)}
        if layer["pred_hand_key"] is not None:
            terms["loss_hand_keypoint"], terms["loss_obj_keypoint"] = criterion.loss_keypoints(
                layer["pred_hand_key"], layer["pred_obj_key"], targets["labels"],
                targets["keypoints"], assign, tgt_valid)
        terms.update(criterion.compute_small_loss(criterion.select_queries(layer), targets,
                                                  *world, IMG_RES))
        for k, v in terms.items():
            assert v.shape == ()
            ld[k if lvl == FL - 1 else f"{k}_{lvl}"] = v
            total = total + criterion.DEFAULT_LOSS_WEIGHTS.get(k, 0.0) * v
    return total, ld


@pytest.mark.parametrize("variant,two_stage", [("contacts_partial", True),
                                               ("right_gate_closed", True),
                                               ("contacts_partial", False)])
def test_folded_layers_equal_a_loop_over_layers(port_world, variant, two_stage):
    targets = fold_targets(port_world, variant)
    outputs = fold_outputs(two_stage)
    st = outputs["stacked"]
    leaves = {k: v for k, v in st.items() if v is not None}

    total, ld = criterion.arctic_criterion(outputs, targets, *port_world, img_res=IMG_RES)
    grads = torch.autograd.grad(total, list(leaves.values()))
    ref_total, ref_ld = per_layer_loop(outputs, targets, port_world)
    ref_grads = torch.autograd.grad(ref_total, list(leaves.values()))

    assert set(ld) == set(ref_ld) | {"cardinality_error", "total"}
    for k, v in ref_ld.items():
        assert ld[k].shape == ()
        np.testing.assert_allclose(ld[k].item(), v.item(), rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_allclose(total.item(), ref_total.item(), rtol=1e-6, err_msg="total")
    # every family of terms does work somewhere
    for k in ("loss/cd", "loss/object/v3d_smoothing", "loss/mano/kp3d/l", "loss_ce"):
        assert ref_ld[k].item() > 0, k
    assert (ref_ld["loss/mano/kp3d/r"].item() == 0) == (variant == "right_gate_closed")
    for (k, g), r in zip(zip(leaves, grads), ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * max(float(r.abs().max()), 1e-12), err_msg=k)


# `compute_small_loss` of layer 2's selected queries as the function computed
# it before the layers were folded (one layer a call), on the targets and
# outputs above.
ONE_LAYER_SMALL = {
    "contacts_partial": {
        "loss/cd": 4.554605960845947,
        "loss/mano/beta/l": 0.48160186409950256,
        "loss/mano/beta/r": 0.6239266395568848,
        "loss/mano/cam_t/l": 0.012596813030540943,
        "loss/mano/cam_t/r": 0.01111303549259901,
        "loss/mano/kp2d/l": 0.005991156212985516,
        "loss/mano/kp2d/r": 0.006506110075861216,
        "loss/mano/kp3d/l": 0.0006209243438206613,
        "loss/mano/kp3d/r": 0.0003557520976755768,
        "loss/mano/pose/l": 0.08583678305149078,
        "loss/mano/pose/r": 0.07876700162887573,
        "loss/mano/transl/l": 0.01053323969244957,
        "loss/object/cam_t": 0.026320254430174828,
        "loss/object/kp2d": 0.01598431169986725,
        "loss/object/kp3d": 0.0009751905454322696,
        "loss/object/radian": 0.11464526504278183,
        "loss/object/rot": 0.1373147964477539,
        "loss/object/transl": 0.02512395940721035,
        "loss/object/v3d_smoothing": 1564.3369140625,
    },
    "right_gate_closed": {
        "loss/cd": 3.0833849906921387,
        "loss/mano/kp3d/l": 0.0006209243438206613,
        "loss/mano/kp3d/r": 0.0,
        "loss/mano/transl/l": 0.0,
        "loss/object/cam_t": 0.020833933725953102,
        "loss/object/kp2d": 0.012020209804177284,
        "loss/object/transl": 0.0,
    },
}


@pytest.mark.parametrize("variant", sorted(ONE_LAYER_SMALL))
def test_one_layer_small_loss_keeps_its_values(port_world, variant):
    targets = fold_targets(port_world, variant)
    layer = {k: v[2].detach() for k, v in fold_outputs()["stacked"].items()}
    small = criterion.compute_small_loss(criterion.select_queries(layer), targets, *port_world,
                                         IMG_RES)
    assert set(small) == set(ONE_LAYER_SMALL["contacts_partial"])
    for k, want in ONE_LAYER_SMALL[variant].items():
        assert small[k].shape == ()
        np.testing.assert_allclose(float(small[k]), want, rtol=1e-6, atol=0, err_msg=k)


VIEW_OPS = {"aten::view", "aten::reshape", "aten::_reshape_alias", "aten::_unsafe_view",
            "aten::select", "aten::slice", "aten::expand", "aten::expand_as", "aten::unsqueeze",
            "aten::squeeze", "aten::as_strided", "aten::permute", "aten::transpose", "aten::t",
            "aten::alias", "aten::detach", "aten::unbind", "aten::flatten", "aten::narrow",
            "aten::split", "aten::chunk", "aten::view_as", "aten::lift_fresh"}


def layer_loss_ops(outputs, targets, world):
    """The aten ops, views left out, that run directly inside the criterion's
    `layer_losses` span (a CPU profile of one call)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        criterion.arctic_criterion(outputs, targets, *world, img_res=IMG_RES)
    spans = [e for e in prof.events() if e.name == "layer_losses"]
    assert len(spans) == 1
    return [c.name for c in spans[0].cpu_children
            if c.name.startswith("aten::") and c.name not in VIEW_OPS]


def test_the_layer_losses_run_about_one_layers_ops(port_world):
    """Six layers cost at most 1.5x the ops of one: the per-layer losses run
    once on the folded batch, not once a layer."""
    targets = fold_targets(port_world)
    six = fold_outputs()
    one = {"stacked": {k: v[-1:] for k, v in six["stacked"].items()}}
    n_one, n_six = (len(layer_loss_ops(o, targets, port_world)) for o in (one, six))
    assert n_one > 300  # the span holds the per-layer losses
    assert n_six <= 1.5 * n_one, (n_one, n_six)

"""The port's InceptionV3 detector against the JAX one, on the CPU.

JAX random parameters (batch-norm scale and offset perturbed, so the
folded batch norm is exercised) are carried over by ``bridge``; both
variants run at ``resize_to`` 75–96 and batch 2, once growing and once
shrinking the input (the two resize regimes of each variant).  Features
and the 1008 logits agree to 1e-4 of their largest magnitude: the same
float32 convolutions, summed in another order.  The ``.npz`` round trip
goes through the flat format of ``tools/convert_detector.py``.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from gantrack_tpu.models import inception as jinc
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import inception as tinc

torch.set_num_threads(1)


def _jax_variables(variant, resize_to):
    model = jinc.InceptionV3Features(resize_to=resize_to, variant=variant, return_logits=True)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    flat = flax.traverse_util.flatten_dict(variables["params"])
    rng = np.random.default_rng(1)
    for key in flat:
        if key[-1] in ("bn_scale", "bn_offset"):
            flat[key] = np.asarray(flat[key]) + 0.1 * rng.standard_normal(flat[key].shape)
    return {"params": flax.traverse_util.unflatten_dict(flat)}


@pytest.mark.parametrize("variant,size,resize_to", [
    ("torchvision", 64, 80), ("torchvision", 120, 75),
    ("tfslim", 60, 96), ("tfslim", 100, 75),
])
def test_inception_matches_jax(variant, size, resize_to):
    variables = _jax_variables(variant, resize_to)
    x = np.random.default_rng(2).uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    sd = bridge.flax_state_dict_from_jax(variables)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for logits in (False, True):
        jm = jinc.InceptionV3Features(resize_to=resize_to, variant=variant, return_logits=logits)
        want = np.asarray(jm.apply(variables, jnp.asarray(x)))
        tm = tinc.InceptionV3Features(resize_to=resize_to, variant=variant, return_logits=logits)
        tm.load_state_dict({k: v for k, v in sd.items()
                            if logits or not k.startswith("output.")}, strict=True)
        with torch.no_grad():
            got = tm(xt).numpy()
        assert got.shape == want.shape == (2, 1008 if logits else 2048)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 120])
def test_tf1_resize_matches_jax(size):
    x = np.random.default_rng(3).uniform(0, 255, (1, size, size + 3, 3)).astype(np.float32)
    want = np.asarray(jinc.tf1_resize_bilinear(jnp.asarray(x), 90, 77))
    got = tinc.tf1_resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2)), 90, 77)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-3)


def test_npz_round_trip_keeps_variant_and_weights(tmp_path):
    torch.manual_seed(0)
    model = tinc.InceptionV3Features(variant="tfslim", return_logits=True)
    path = str(tmp_path / "inception.npz")
    tinc.save_npz(path, model)
    data = dict(np.load(path))
    assert str(data["__variant__"]) == "tfslim"
    assert data["Mixed_5b/branch1x1/conv/kernel"].shape == (1, 1, 192, 64)  # HWIO
    assert data["output/kernel"].shape == (2048, 1008)
    loaded = tinc.load_npz(path, return_logits=True)
    assert loaded.variant == "tfslim"
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b)

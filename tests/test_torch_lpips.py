"""The port's LPIPS (``gsplat_tpu_torch/viz/lpips.py``) against the JAX
module on the CPU, for the three backbones, on seeded weights with the
official key schemas converted by ``tools/convert_lpips_weights.py``
(``tests/test_lpips.py``'s synthetic checkpoints), at 48x48."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from convert_lpips_weights import convert  # noqa: E402

import test_lpips as jtest  # noqa: E402  (its synthetic checkpoints)
from gsplat_tpu.viz.lpips import LPIPS as JLPIPS  # noqa: E402
from gsplat_tpu_torch.viz.lpips import LPIPS  # noqa: E402

import torch_helpers  # noqa: E402,F401  (thread count)

SYNTH = {"vgg": jtest._synth_state_dicts,
         "alex": jtest._synth_alex_state_dicts,
         "squeeze": jtest._synth_squeeze_state_dicts}


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(net, tmp_path):
    """The port's score within 1e-5 relative of the JAX module's on a
    seeded pair and its identity pair at 0."""
    rng = np.random.default_rng({"alex": 23, "vgg": 11, "squeeze": 31}[net])
    sd, lin_sd = SYNTH[net](rng)
    path = str(tmp_path / f"{net}.npz")
    np.savez(path, **convert(sd, lin_sd, net=net))
    a = rng.uniform(0, 1, (3, 48, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape).astype(np.float32), 0, 1)

    want = JLPIPS(weights_path=path)(jnp.asarray(a), jnp.asarray(b))
    model = LPIPS(weights_path=path, device="cpu")
    assert model.net_type == net
    got = model(a, b)
    assert want > 0
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert model(torch.from_numpy(a), torch.from_numpy(a)) == pytest.approx(
        0, abs=1e-7)


def test_lpips_needs_weights(monkeypatch, tmp_path):
    """No weights named: ``FileNotFoundError``, and the metrics CLI goes on
    without LPIPS; a net other than the file's: ``ValueError``."""
    from gsplat_tpu_torch.scripts.metrics import try_lpips

    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError):
        LPIPS(device="cpu")
    assert try_lpips("cpu") is None
    sd, lin_sd = jtest._synth_alex_state_dicts(np.random.default_rng(5))
    path = str(tmp_path / "alex.npz")
    np.savez(path, **convert(sd, lin_sd, net="alex"))
    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", path)
    assert try_lpips("cpu").net_type == "alex"
    with pytest.raises(ValueError):
        LPIPS(net_type="vgg", device="cpu")

"""
The port's ``BirdviewCNNPolicy`` against the flax module with the same
parameters, carried across by ``convert.policy_state_dict_from_flax``.

Tolerances: 1e-5 absolute on the tanh outputs in float32 (the convolutions
sum in a different order); 2e-2 in bfloat16, where each layer rounds its
activations to 8 bits of mantissa on both sides but XLA and PyTorch round
the intermediate sums at different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu.models import BirdviewCNNPolicy as FlaxPolicy
from torchdrivesim_tpu_torch.convert import policy_state_dict_from_flax
from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
from torchdrivesim_tpu_torch.models import policy as policy_module

torch.set_num_threads(1)


def _pair(features, dtype, res, action_size=2):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    flax = FlaxPolicy(action_size=action_size, features=features, dtype=jdtype)
    params = jax.tree.map(np.asarray, flax.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 3, res, res))))
    # a larger output layer moves the actions off tanh's linear middle, so
    # the comparison sees the whole range
    params['params']['Dense_1']['kernel'] = params['params']['Dense_1']['kernel'] * 30
    port = BirdviewCNNPolicy(action_size, features, dtype=dtype)
    port.load_state_dict(policy_state_dict_from_flax(params))
    return flax, params, port


def _images(seed, b, res):
    return np.random.RandomState(seed).uniform(0, 255, (b, 3, res, res)).astype(np.float32)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('res,features', [(32, (4, 8)), (33, (4, 8)), (64, (16, 32))])
def test_policy_matches_flax(dtype, tol, res, features):
    flax, params, port = _pair(features, dtype, res, action_size=4)
    images = _images(res, 3, res)
    want = np.asarray(flax.apply(params, jnp.asarray(images)))
    got = port(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = float(np.abs(got.detach().numpy() - want).max())
    print(f'{dtype} res {res}: max abs difference {err:.3g}')
    assert err <= tol
    assert np.abs(want).max() > 0.3               # the comparison has signal


def test_symmetric_padding_would_disagree(monkeypatch):
    """flax pads a stride-2 3 x 3 convolution of an even input by 0 before
    and 1 after; PyTorch's symmetric padding=1 gives other outputs."""
    flax, params, port = _pair((4, 8), torch.float32, 32)
    images = _images(0, 3, 32)
    want = np.asarray(flax.apply(params, jnp.asarray(images)))
    assert policy_module._same_pad(32, 3, 2) == (0, 1)
    monkeypatch.setattr(policy_module, '_same_pad', lambda size, kernel, stride: (1, 1))
    wrong = port(torch.from_numpy(images)).detach().numpy()
    assert float(np.abs(wrong - want).max()) > 1e-3


def test_state_dict_layout():
    flax, params, port = _pair((4, 8), torch.float32, 32)
    sd = policy_state_dict_from_flax(params)
    assert set(sd) == set(port.state_dict())
    k = np.asarray(params['params']['Conv_0']['kernel'])         # HWIO
    np.testing.assert_array_equal(sd['convs.0.weight'].numpy()[2, 1, 0, 2], k[0, 2, 1, 2])
    d = np.asarray(params['params']['Dense_1']['kernel'])        # (in, out)
    np.testing.assert_array_equal(sd['dense_1.weight'].numpy(), d.T)

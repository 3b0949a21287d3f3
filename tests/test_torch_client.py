"""One client's local training (tau = 2 steps of clipped momentum SGD)
in the port against ``repro.fl.client.local_train``, on the golden
problem's data with the params and key carried across."""
import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")
from jax.flatten_util import ravel_pytree

from repro.configs.paper_models import BENCH_CNN_CIFAR, BENCH_MLP
from repro.data import make_federated_classification
from repro.fl import client as jclient
from repro.models import cnn as jcnn
from repro_torch import convert, prng
from repro_torch.configs import paper_models as tpm
from repro_torch.fl import client as tclient
from repro_torch.models import cnn as tcnn
from repro_torch.tree import ravel

CFGS = {"mlp": (BENCH_MLP, tpm.BENCH_MLP, (1, 8, 8)),
        "vgg": (BENCH_CNN_CIFAR, tpm.BENCH_CNN_CIFAR, (3, 16, 16))}


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.mark.parametrize("arch", sorted(CFGS))
@pytest.mark.parametrize("client", [0, 7])
def test_local_train_delta_matches(arch, client):
    jcfg, tcfg, shape = CFGS[arch]
    key = jax.random.PRNGKey(0)
    jparams = jcnn.init_cnn(key, jcfg)
    x, y, _, _ = make_federated_classification(
        key, n_clients=20, per_client=20, num_classes=10, image_shape=shape)
    ck = jax.random.fold_in(jax.random.PRNGKey(5), client)
    kw = dict(steps=2, lr=0.05, clip=1.0, momentum=0.9)

    jnew, jloss = jclient.local_train(
        jparams, x[client], y[client], ck,
        loss_fn=lambda p, b: jcnn.cnn_loss(p, jcfg, b), **kw)
    jdelta = np.asarray(ravel_pytree(jclient.model_update(jparams,
                                                          jnew))[0])

    tparams = convert.params_from_jax(jax.device_get(jparams), "cpu")
    tnew, tloss = tclient.local_train(
        tparams, torch.as_tensor(np.array(x[client])),
        torch.as_tensor(np.array(y[client])).long(),
        prng.key_from_words(np.asarray(ck), "cpu"),
        loss_fn=lambda p, b: tcnn.cnn_loss(p, tcfg, b), **kw)
    tdelta = ravel(tclient.model_update(tparams, tnew)).numpy()

    # f32 gradients in another summation order, then two SGD steps and
    # one clip: the update agrees to a few ulp of its scale
    scale = np.abs(jdelta).max()
    np.testing.assert_allclose(tdelta, jdelta, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert np.linalg.norm(tdelta) > 0

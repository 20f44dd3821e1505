"""The port's data pipeline (`tdgp_torch.data.dataset`, `tdgp_torch.training.loop.to_device`)
against the JAX package's (`tdgp.data.dataset`) on a tiny folder that
`data_scripts/make_synthetic_dataset.py` writes: every item, the sampler's
index stream, the loader's batches and `normalize_batch` in both modes, all
exactly; the compact batch normalized by `to_device` as `normalize_batch`
does on the host, bit for bit; a loader worker's failure raised to the
consumer.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tdgp.data import dataset as jax_data

from tdgp_torch.data import dataset as port_data
from tdgp_torch.training.loop import to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('synth') / 'synth16')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', out, '--n', '12', '--res', '16', '--classes', '3'],
                   check=True, capture_output=True, timeout=120)
    return out


def datasets(folder, **kwargs):
    kw = dict(resolution=16, use_labels=True, use_depth=True, mirror=True, **kwargs)
    return port_data.ImageFolderDataset(folder, **kw), jax_data.ImageFolderDataset(folder, **kw)


def assert_same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('max_size', [None, 7])
def test_items_as_jax(folder, max_size):
    port, ref = datasets(folder, max_size=max_size)
    assert len(port) == len(ref) == 2 * (max_size or 12)
    assert (port.name, port.resolution, port.label_dim) == (ref.name, ref.resolution,
                                                           ref.label_dim)
    for i in range(len(port)):
        assert_same_batch(port[i], ref[i])


@pytest.mark.parametrize('rank,num_replicas,seed', [(0, 1, 0), (1, 3, 5)])
def test_sampler_order_as_jax(rank, num_replicas, seed):
    port = iter(port_data.InfiniteSampler(10, rank=rank, num_replicas=num_replicas, seed=seed))
    ref = iter(jax_data.InfiniteSampler(10, rank=rank, num_replicas=num_replicas, seed=seed))
    assert [next(port) for _ in range(50)] == [next(ref) for _ in range(50)]


@pytest.mark.parametrize('compact', [False, True])
def test_loader_and_normalize_batch_as_jax(folder, compact):
    """One loader thread each, so that the batches come in the sampler's order."""
    port_ds, ref_ds = datasets(folder)
    port = port_data.BatchLoader(port_ds, 5, seed=3, num_threads=1)
    ref = jax_data.BatchLoader(ref_ds, 5, seed=3, num_threads=1)
    try:
        for _ in range(4):
            a, b = next(port), next(ref)
            assert_same_batch(a, b)
            assert_same_batch(port_data.normalize_batch(a, compact=compact),
                              jax_data.normalize_batch(b, compact=compact))
    finally:
        port.close()
        ref.close()


def test_to_device_normalizes_the_compact_batch_as_the_host(folder):
    ds, _ = datasets(folder)
    items = [ds[i] for i in range(6)]
    raw = {k: np.stack([it[k] for it in items]) for k in items[0]}
    raw['depth'][0, 0, 0, 0] = 65535  # the top of the u16 range survives the int16 copy
    host = port_data.normalize_batch(raw, compact=False)
    dev = to_device(port_data.normalize_batch(raw, compact=True), torch.device('cpu'))
    assert set(dev) == set(host)
    for k, v in host.items():
        assert dev[k].dtype == torch.float32
        np.testing.assert_array_equal(dev[k].numpy(), v, err_msg=k)


class _Unreadable:
    def __len__(self):
        return 4

    def __getitem__(self, idx):
        raise OSError('unreadable image')


def test_loader_worker_failure_reaches_the_consumer():
    loader = port_data.BatchLoader(_Unreadable(), 2, num_threads=2)
    with pytest.raises(RuntimeError, match='worker failed') as info:
        next(loader)
    assert isinstance(info.value.__cause__, OSError)

"""The port's data preparation (`data/preprocess.py`, `data/alexnet.py`)
against the JAX package's on the same local files, on the CPU: idx files
(plain and gzipped) and CIFAR-10 binary batches written from numpy, the
TSV files each package writes compared byte for byte, through the
functions and through `main`; the AlexNet featurizer's seeded parameters,
its features with the reference's parameters carried across
(`convert.alexnet_from_numpy`, rtol 1e-5), a local weights file, and the
Caltech-101 folder featurized to the reference's TSV (PIL only there)."""

import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu.data import alexnet as jalex  # noqa: E402
from cryptonets_tpu.data import preprocess as jprep  # noqa: E402
from cryptonets_tpu_torch import convert  # noqa: E402
from cryptonets_tpu_torch.data import alexnet  # noqa: E402
from cryptonets_tpu_torch.data import preprocess  # noqa: E402

RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread on the port's side, as the other port tests, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_idx(path, arr: np.ndarray):
    """An idx file of uint8 `arr` (magic 0x0000 08 ndim, big-endian dims)."""
    head = struct.pack(">I", 0x0800 | arr.ndim)
    head += b"".join(struct.pack(">I", d) for d in arr.shape)
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wb") as fh:
        fh.write(head + arr.astype(np.uint8).tobytes())


@pytest.fixture
def mnist(tmp_path):
    """A 5-image idx pair, gzipped under the reference's file names."""
    images = RNG.integers(0, 256, (5, 28, 28)) * (RNG.random((5, 28, 28)) < 0.2)
    labels = RNG.integers(0, 10, 5)
    paths = (tmp_path / "t10k-images-idx3-ubyte.gz",
             tmp_path / "t10k-labels-idx1-ubyte.gz")
    _write_idx(paths[0], images)
    _write_idx(paths[1], labels)
    return tmp_path, [str(p) for p in paths], images, labels


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_read_idx_equals_reference(tmp_path, gz):
    arr = RNG.integers(0, 256, (3, 4, 5))
    path = str(tmp_path / ("a.idx.gz" if gz else "a.idx"))
    _write_idx(path, arr)
    got = preprocess.read_idx(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jprep.read_idx(path))


def test_mnist_tsv_and_records_equal_reference(mnist):
    d, (im, lb), images, labels = mnist
    ours, theirs = d / "ours.txt", d / "theirs.txt"
    preprocess.mnist_to_sparse_tsv(im, lb, str(ours))
    jprep.mnist_to_sparse_tsv(im, lb, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    first = ours.read_text().splitlines()[0].split("\t")
    assert first[:2] == [str(labels[0]), "784"]
    for count in (None, 2):
        got = preprocess.load_mnist_records(im, lb, count)
        want = jprep.load_mnist_records(im, lb, count)
        assert len(got) == len(want) == (count or 5)
        for (gl, gf), (wl, wf) in zip(got, want):
            assert gl == wl and gf.dtype == np.float64
            np.testing.assert_array_equal(gf, wf)


def _cifar_batch(path, count):
    raw = RNG.integers(0, 256, (count, 3073)).astype(np.uint8)
    raw[:, 0] %= 10
    raw.tofile(path)


def test_cifar_tsv_equals_reference(tmp_path):
    paths = [str(tmp_path / f"b{i}.bin") for i in range(2)]
    for i, p in enumerate(paths):
        _cifar_batch(p, 2 + i)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    preprocess.cifar_to_dense_tsv(paths, str(ours))
    jprep.cifar_to_dense_tsv(paths, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_text().splitlines()) == 5


@pytest.mark.parametrize("kind", ["MNIST", "CIFAR"])
def test_main_writes_the_reference_files(mnist, kind, tmp_path_factory, monkeypatch):
    src = mnist[0]
    _cifar_batch(str(src / "test_batch.bin"), 3)
    name = {"MNIST": "MNIST-28x28-test.txt", "CIFAR": "cifar-test.txt"}[kind]
    outs = []
    for run in (lambda: preprocess.main([kind, str(src)]),
                lambda: (monkeypatch.setattr("sys.argv", ["p", kind, str(src)]),
                         jprep.main())):
        out = tmp_path_factory.mktemp("out")
        monkeypatch.chdir(out)
        run()
        outs.append((out / name).read_bytes())
    assert outs[0] == outs[1] and outs[0]


# ----------------------------------------------------------------- AlexNet
@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).integers(0, 256, (2, 227, 227, 3)).astype(np.uint8)


def test_seeded_parameters_equal_reference():
    """A seed draws the reference's parameters, from an explicit generator:
    the global random state is left as it was."""
    state = torch.random.get_rng_state()
    ours = alexnet.AlexNetFeaturizer(seed=4, device="cpu").model.state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    theirs = jalex.AlexNetFeaturizer(seed=4).model.state_dict()
    assert list(ours) == list(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)


def test_features_with_reference_parameters(images):
    """The reference's parameters carried across as numpy arrays: the
    features agree at rtol 1e-5 (both run float32 on the CPU), with the
    zeros of the ReLU in the same places."""
    ref = jalex.AlexNetFeaturizer(seed=1)
    port = alexnet.AlexNetFeaturizer(seed=2, device="cpu")
    convert.alexnet_from_numpy(
        port, {k: v.numpy() for k, v in ref.model.state_dict().items()})
    got, want = port(images), ref(images)
    assert got.shape == (2, 4096) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    with pytest.raises(ValueError):
        port(images[:, :200])


def test_local_weights_file(images, tmp_path):
    """A torchvision-format state_dict from a local file (fc8 dropped)."""
    src = jalex.AlexNetFeaturizer(seed=8).model.state_dict()
    src["classifier.6.weight"] = torch.zeros(1000, 4096)
    src["classifier.6.bias"] = torch.zeros(1000)
    path = str(tmp_path / "alexnet.pth")
    torch.save(src, path)
    port = alexnet.AlexNetFeaturizer(path, device="cpu")
    ref = jalex.AlexNetFeaturizer(path)
    assert port.pretrained and ref.pretrained
    np.testing.assert_allclose(port(images), ref(images), rtol=1e-5, atol=0)


def test_caltech_folder_to_reference_tsv(tmp_path, monkeypatch):
    """Two classes of small images (PIL writes and reads them): the port's
    `featurize_directory` and the CAL branch of `main` write the
    reference's TSV byte for byte."""
    Image = pytest.importorskip("PIL.Image")
    src = tmp_path / "101_ObjectCategories"
    for c, cls in enumerate(("ant", "bee")):
        (src / cls).mkdir(parents=True)
        for i in range(2):
            px = np.random.default_rng(10 * c + i).integers(0, 256, (40, 50, 3))
            Image.fromarray(px.astype(np.uint8)).save(src / cls / f"{i}.png")
    ours, theirs = tmp_path / "ours.tsv", tmp_path / "theirs.tsv"
    assert alexnet.featurize_directory(str(src), str(ours), device="cpu") == 4
    assert jalex.featurize_directory(str(src), str(theirs)) == 4
    assert ours.read_bytes() == theirs.read_bytes()
    assert alexnet.load_image(str(src / "ant" / "0.png")).shape == (227, 227, 3)
    monkeypatch.chdir(tmp_path)
    preprocess.main(["CAL", str(src), "--device", "cpu"])
    assert (tmp_path / "cal_deep_test.tsv").read_bytes() == theirs.read_bytes()

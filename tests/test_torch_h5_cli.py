"""The cardata CLI's ``.h5`` model files (``iotml_torch.cli._app``), held
against the JAX CLI on the CPU at a small size (emulator:3000, batch 10,
2 epochs): train exports Keras h5 into the store, predict imports it;
each package predicts from the other's file.

Tolerances:
- return codes, committed offsets and the number and order of
  predictions: equal;
- the h5 the port's train stores, read by the JAX package's importer and
  by the port's: the same params, bit for bit;
- predict payloads of the two CLIs from the same h5: the printed values
  parsed as floats, atol 1e-6 (``np.array2string`` of two float32
  forwards an ulp apart can differ in the last printed digit).
"""

import json
import shutil

import numpy as np
import pytest

from iotml.cli import _app as j_app
from iotml.cli import cardata as j_cardata
from iotml.models.h5_import import autoencoder_params_from_h5 as j_from_h5
from iotml_torch.cli import _app as t_app
from iotml_torch.cli import cardata
from iotml_torch.models.autoencoder import PARAM_NAMES
from iotml_torch.models.convert import params_from_jax
from iotml_torch.models.h5_import import autoencoder_params_from_h5

TOPIC, GROUP = "SENSOR_DATA_S_AVRO", "cardata-autoencoder"
SMALL = ["--train.epochs=2", "--train.batch_size=10"]
PAYLOAD_ATOL = 1e-6


def _argv(mode, root, model="model1.h5"):
    return ["emulator:3000", TOPIC, "0", "model-predictions", mode, model,
            str(root), *SMALL]


def _run(main, app, argv, **kw):
    """Run a CLI main; returns (rc, the broker it made)."""
    seen = []
    real = app._broker_for

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(app, "_broker_for", spy)
        rc = main(argv, **kw)
    return rc, seen[0] if seen else None


def _payloads(broker):
    end = broker.end_offset("model-predictions", 0)
    return [m.value.decode()
            for m in broker.fetch("model-predictions", 0, 0, end + 1)]


def _assert_payloads_close(got, want):
    assert len(got) == len(want) == 1000
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.array(g.strip("[]").split(), np.float64),
            np.array(w.strip("[]").split(), np.float64),
            rtol=0, atol=PAYLOAD_ATOL)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs' train of model1.h5 into their own stores."""
    roots = {k: tmp_path_factory.mktemp(f"{k}_store") for k in ("t", "j")}
    rc_t, t_broker = _run(cardata.main, t_app, _argv("train", roots["t"]),
                          device="cpu")
    rc_j, j_broker = _run(j_cardata.main, j_app, _argv("train", roots["j"]))
    assert rc_t == rc_j == 0
    return roots, t_broker, j_broker


def test_train_stores_keras_h5_and_commits_like_jax(trained, capsys):
    roots, t_broker, j_broker = trained
    assert t_broker.committed(GROUP, TOPIC, 0) == \
        j_broker.committed(GROUP, TOPIC, 0) == 1010
    path = str(roots["t"] / "model1.h5")
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89HDF\r\n\x1a\n"
    got = autoencoder_params_from_h5(path)
    want = params_from_jax(j_from_h5(path))
    assert all(got[k].numpy().tobytes() == want[k].numpy().tobytes()
               for k in PARAM_NAMES)
    assert got["encoder0.weight"].shape == (14, 18)


@pytest.mark.parametrize("writer", ["t", "j"])
def test_each_cli_predicts_from_either_packages_h5(trained, tmp_path,
                                                   writer):
    """One package's trained model1.h5 in both stores: the port's and the
    JAX CLI's predict payloads agree, and commit alike."""
    roots = trained[0]
    stores = {k: tmp_path / k for k in ("t", "j")}
    for root in stores.values():
        root.mkdir()
        shutil.copy(roots[writer] / "model1.h5", root / "model1.h5")
    rc_t, t_broker = _run(cardata.main, t_app, _argv("predict", stores["t"]),
                          device="cpu")
    rc_j, j_broker = _run(j_cardata.main, j_app,
                          _argv("predict", stores["j"]))
    assert rc_t == rc_j == 0
    _assert_payloads_close(_payloads(t_broker), _payloads(j_broker))
    assert t_broker.committed(GROUP, TOPIC, 0) == \
        j_broker.committed(GROUP, TOPIC, 0) == 2000


def test_predict_stats_line_after_h5_restore(trained, capsys):
    rc, _ = _run(cardata.main, t_app, _argv("predict", trained[0]["t"]),
                 device="cpu")
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.split("stats: ")[-1])
    assert stats["mode"] == "predict" and stats["rows"] == 1000

"""The loggers of the port against ``vts_tpu`` on the CPU:

  * the live dashboard (``--display_port 0``: a port the OS picks, so that
    test workers never share one): after the same pushes, ``/data.json`` and
    ``/images/<f>`` give the reference's bytes and ``/`` its page with the
    package's name; anything outside the image folder is a 404;
    ``--display_id 0`` starts nothing, and a busy port prints the
    reference's note and gives ``None``;
  * the ``Visualizer``: the dashboard started from the options, the losses,
    metrics, images and epoch times pushed as the reference's Visualizer
    pushes them, and ``close`` stopping the server; the wandb gate prints the
    reference's line when wandb is missing (it is not installed) and, with a
    stand-in module, logs the reference's keys;
  * ``vts_torch.train`` with ``--display_id 1``: each loss line and epoch
    time reaches the dashboard, which is closed when training ends.
"""

import json
import socket
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from vts_torch.utils import live as port_live
from vts_tpu.utils import live as jax_live
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _push(dash):
    dash.push_losses(1, 5, {"G_total": 1.5, "D_real_I": 0.7})
    dash.push_losses(2, 10, {"G_total": np.float32(1.25), "D_real_I": 0.72})
    dash.push_metrics(1, {"metric_I_PSNR": 21.0})
    dash.push_epoch_time(1, 12.5)
    dash.push_images(["epoch001_fake_I.png"])


def test_dashboard_endpoints_match_jax(tmp_path):
    (tmp_path / "epoch001_fake_I.png").write_bytes(b"\x89PNG bytes")
    (tmp_path.parent / "secret.txt").write_bytes(b"outside")
    got = {}
    for key, live in (("jax", jax_live), ("port", port_live)):
        dash = live.LiveDashboard("run", str(tmp_path), port=0)
        try:
            assert dash.url == f"http://127.0.0.1:{dash.port}/" and dash.port > 0
            _push(dash)
            got[key] = [_get(dash.url + path) for path in (
                "", "data.json", "images/epoch001_fake_I.png", "images/../secret.txt",
                "images/missing.png", "nothing")]
        finally:
            dash.close()
    page_j, page_p = got["jax"][0], got["port"][0]
    assert page_p[:2] == page_j[:2] == (200, "text/html")
    assert page_p[2].replace(b"vts_torch", b"vts_tpu") == page_j[2]
    assert got["port"][1:] == got["jax"][1:]
    assert [r[0] for r in got["port"]] == [200, 200, 200, 404, 404, 404]
    data = json.loads(got["port"][1][2])
    assert data["epoch"] == 2 and [r["v"]["G_total"] for r in data["losses"]] == [1.5, 1.25]
    assert data["epoch_times"] == [[1, 12.5]] and data["images"] == ["epoch001_fake_I.png"]


def _opt(tmp_path, **kw):
    base = dict(name="live", checkpoints_dir=str(tmp_path), display_id=1, display_port=0,
                use_wandb=False, no_html=False, display_winsize=32, results_dir=str(tmp_path),
                phase="train")
    return types.SimpleNamespace(**{**base, **kw})


def test_display_id_0_starts_nothing_and_a_busy_port_gives_none(tmp_path, capsys):
    assert port_live.maybe_start(_opt(tmp_path, display_id=0), str(tmp_path)) is None
    assert jax_live.maybe_start(_opt(tmp_path, display_id=0), str(tmp_path)) is None
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        opt = _opt(tmp_path, display_port=busy.getsockname()[1])
        capsys.readouterr()
        assert jax_live.maybe_start(opt, str(tmp_path)) is None
        want = capsys.readouterr().out
        assert port_live.maybe_start(opt, str(tmp_path)) is None
        assert capsys.readouterr().out == want
    assert want.startswith(f"[visualizer] live dashboard unavailable on :{opt.display_port} (")


def _drive(vis):
    vis.print_current_losses(1, 4, {"G_total": 2.0, "D_real_I": 0.5}, 0.1, 0.0)
    vis.print_current_metrics(1, {"metric_T_MSE": 0.5})
    vis.display_current_results({"fake_I": np.zeros((1, 8, 8, 3), np.float32)}, 1)
    vis.plot_epoch_time(1, 3.25)


def test_visualizer_pushes_as_the_reference(tmp_path):
    from vts_torch.utils.visualizer import Visualizer
    from vts_tpu.utils.visualizer import Visualizer as JaxVisualizer
    data = {}
    for key, cls in (("jax", JaxVisualizer), ("port", Visualizer)):
        vis = cls(_opt(tmp_path / key))
        try:
            assert vis.dashboard is not None
            _drive(vis)
            data[key] = json.loads(_get(vis.dashboard.url + "data.json")[2])
            status = _get(vis.dashboard.url + "images/epoch001_fake_I.png")[0]
            assert status == 200
        finally:
            if key == "port":
                url = vis.dashboard.url
                vis.close()
                assert vis.dashboard is None
                with pytest.raises(urllib.error.URLError):
                    urllib.request.urlopen(url + "data.json", timeout=5)
            else:
                vis.dashboard.close()
    assert data["port"] == data["jax"]
    assert data["port"]["epoch_times"] == [[1, 3.25]]


@pytest.mark.parametrize("wandb", ["missing", "stand-in"])
def test_wandb_gate(wandb, tmp_path, monkeypatch, capsys):
    """wandb is installed neither here nor on the card: the reference's line,
    and no sink.  A stand-in module gets the reference's project, run name
    and logged keys."""
    from vts_torch.utils.visualizer import Visualizer
    from vts_tpu.utils.visualizer import Visualizer as JaxVisualizer
    logs = {"jax": [], "port": []}
    for key, cls in (("jax", JaxVisualizer), ("port", Visualizer)):
        if wandb == "missing":
            monkeypatch.setitem(sys.modules, "wandb", None)
        else:
            run = types.SimpleNamespace(log=logs[key].append)
            monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
                run=None, init=lambda project, name, config: logs[key].append(
                    (project, name)) or run))
        vis = cls(_opt(tmp_path / key, use_wandb=True, display_id=0))
        out = capsys.readouterr().out
        _drive(vis)
        if wandb == "missing":
            assert vis.wandb is None
            assert "[visualizer] wandb requested but not installed — skipping" in out
    assert logs["port"] == logs["jax"]
    if wandb == "stand-in":
        assert logs["port"][0] == ("SKIT", "live")
        assert {"l_G_total": 2.0, "l_D_real_I": 0.5} in logs["port"]
        assert {"m_T_MSE": 0.5} in logs["port"]
        assert {"epoch_time_s": 3.25, "epoch": 1} in logs["port"]


def test_training_feeds_and_closes_the_dashboard(tmp_path, monkeypatch):
    """A CPU run of 2 epochs of one step with ``--display_id 1 --display_port
    0``: both loss lines and both epoch times reach the dashboard, and its
    server is closed when ``train`` returns.  Two torch threads, so that the
    test's steps do not wait on the other test workers' threads."""
    import torch
    import vts_torch.utils.visualizer as vis_mod
    from vts_torch.train import train
    started = []

    def spy(opt, img_dir):
        started.append(port_live.maybe_start(opt, img_dir))
        return started[-1]
    monkeypatch.setattr(vis_mod, "maybe_start", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        train(["--device", "cpu", "--name", "live", "--dataroot",
               "synthetic://live?size=320&center_w=192&center_h=128&patches=6&val_patches=3",
               "--crop_size", "256", "--center_w", "192", "--center_h", "128", "--ngf", "4",
               "--ndf", "4", "--batch_size_G2", "1", "--batch_size_G2_val", "1",
               "--add_fake_T_sample_size", "1", "--data_len", "1", "--n_epochs", "2",
               "--n_epochs_decay", "0", "--use_vision_aided_loss", "false", "--no_html",
               "--val_for_each_epoch", "false", "--display_id", "1", "--display_port", "0",
               "--checkpoints_dir", str(tmp_path / "c"), "--results_dir", str(tmp_path / "r")])
    finally:
        torch.set_num_threads(threads)
    (dash,) = started
    assert [(r["e"], r["i"]) for r in dash._losses] == [(1, 1), (2, 2)]
    assert [e for e, _ in dash._epoch_times] == [1, 2]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(dash.url + "data.json", timeout=5)

"""The port's HTTP front (`aclgan_tpu_torch.serving_http`) against the JAX
server over live ephemeral ports, on one `.pt` checkpoint written by the port
(n_res 4: the JAX Translator maps a `.pt` with the default GenConfig)."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from aclgan_tpu.serving import Translator as JTranslator
from aclgan_tpu.serving_http import make_server as jmake_server
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.export import export_translator, save_artifact
from aclgan_tpu_torch.serving import Translator
from aclgan_tpu_torch.serving_http import make_server, server_from_argv
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import save_generators
from tests.helpers import tiny_config


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.aclgan_async.close(drain=False)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    torch.set_num_threads(1)
    jcfg = tiny_config()
    jcfg.gen.n_res = 4
    cfg = from_dict(jcfg.to_dict())
    root = tmp_path_factory.mktemp("http")
    path = str(root / "gen_00000000.pt")
    save_generators(path, ACLGAN(cfg, device="cpu", seed=0))
    tr = Translator(cfg, path, batch_size=2, size=16, seed=1, device="cpu")
    port = make_server(tr, port=0, max_wait_ms=1.0)
    ref = jmake_server(JTranslator(jcfg, path, batch_size=2, size=16, seed=1),
                       port=0, max_wait_ms=1.0)
    yield cfg, path, tr, port, _serve(port), _serve(ref), root
    for httpd in (port, ref):
        _stop(httpd)


def _jpeg(arr, quality=75):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _post(base, body, headers=None, path="/translate"):
    req = urllib.request.Request(base + path, data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_healthz_matches_jax(servers):
    cfg, _, _, _, base, jbase, _ = servers
    bodies = []
    for b in (base, jbase):
        with urllib.request.urlopen(b + "/healthz", timeout=30) as r:
            bodies.append(json.loads(r.read()))
    assert bodies[0] == bodies[1]
    assert bodies[0] == {"status": "ok", "batch_size": 2, "size": 16,
                         "style_dim": cfg.gen.style_dim}


def test_translate_roundtrip_equals_translator(servers):
    """The reply decodes to the port Translator's output on the decoded body,
    encoded the same way (JPEG, quality 95), under an X-Style header."""
    cfg, _, tr, _, base, _, _ = servers
    img = np.random.RandomState(0).randint(0, 256, (20, 24, 3), np.uint8)
    body = _jpeg(img)
    z = np.linspace(-1, 1, cfg.gen.style_dim).astype(np.float32)
    header = {"X-Style": ",".join(repr(float(v)) for v in z)}
    code, ctype, reply = _post(base, body, header)
    assert (code, ctype) == (200, "image/jpeg")
    got = np.asarray(Image.open(io.BytesIO(reply)))
    sent = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.uint8)
    want = tr([sent], styles=z)[0]
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(_jpeg(want, 95)))))
    assert got.shape == (16, 16, 3)
    code2, _, reply2 = _post(base, body, header)
    assert code2 == 200 and reply2 == reply  # a fixed style is deterministic
    assert _post(base, body)[0] == 200      # and no style draws a random one


def test_bad_request_codes_match_jax(servers):
    *_, base, jbase, _ = servers
    good = _jpeg(np.zeros((16, 16, 3), np.uint8))
    cases = [(b"not an image", None, "/translate"), (b"", None, "/translate"),
             (good, {"X-Style": "1.0,2.0"}, "/translate"),
             (good, {"X-Style": "a,b"}, "/translate"), (good, None, "/nope")]
    got, want = [], []
    for body, headers, path in cases:
        for b, out in ((base, got), (jbase, want)):
            code, ctype, reply = _post(b, body, headers, path)
            out.append(code)
            assert ctype == "application/json" and "error" in json.loads(reply)
    assert got == want == [400, 400, 400, 400, 404]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert exc.value.code == 404
    assert _post(base, good)[0] == 200  # the server is still up


def test_listen_backlog_is_128(servers):
    port = servers[3]
    assert port.request_queue_size == 128
    assert port.aclgan_async.max_wait_s == pytest.approx(1e-3)


def test_artifact_mode(servers):
    cfg, path, *_, root = servers
    exported, meta = export_translator(cfg, path, batch_size=3, size=16, device="cpu")
    art = str(root / "tiny.aclt")
    save_artifact(exported, meta, art)
    httpd = server_from_argv(["--artifact", art, "--device", "cpu", "--port", "0",
                              "--max_wait_ms", "1"])
    base = _serve(httpd)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["batch_size"] == 3
        z = ",".join(["0.5"] * cfg.gen.style_dim)
        code, ctype, reply = _post(base, _jpeg(np.full((20, 20, 3), 90, np.uint8)),
                                   {"X-Style": z})
        assert (code, ctype) == (200, "image/jpeg")
        assert Image.open(io.BytesIO(reply)).size == (16, 16)
    finally:
        _stop(httpd)


def test_checkpoint_mode_defaults_to_cuda(servers, tmp_path):
    from aclgan_tpu_torch.config import save_config

    cfg, path, *_ = servers
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    cfg_path = str(tmp_path / "tiny.yaml")
    save_config(cfg, cfg_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        server_from_argv(["--config", cfg_path, "--checkpoint", path, "--port", "0"])
    with pytest.raises(SystemExit):
        server_from_argv(["--config", cfg_path, "--port", "0"])  # no checkpoint


def test_start_without_pillow_names_it(servers, monkeypatch):
    tr = servers[2]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        make_server(tr, port=0)

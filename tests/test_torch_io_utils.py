"""The port's memcached backend, downloads and release script against the
JAX package's on the CPU. Nothing leaves the machine: the servers are
in-process on 127.0.0.1.

- ``MemcachedBackend`` against a fake server on memcached's text
  protocol (as ``tests/test_io_utils.py``): hits, misses (``END``), the
  server-list file, bad keys (ValueError), error replies
  (ConnectionError, the connection dropped and made anew), a server that
  closes mid-value; the same answers from JAX's backend;
- ``utils/download_util`` against an ``http.server`` that behaves as
  Google Drive does for a large file (a ``download_warning`` cookie
  first, the file with ``confirm=<token>``, a ``Content-Range`` for a
  range request): the same bytes as JAX's (on ``requests``, its URL sent
  to the local server); ``load_file_from_url`` and its cache;
  ``save_response_content`` on a ``requests`` response; OSError for a
  host that cannot be reached (a closed local port);
- the download scripts (``download_gdrive``, ``download_pretrained_models``
  with its overwrite question, ``download_datasets``' unzip-and-flatten)
  on the local server;
- ``publish_models``: the same renames as JAX's script for ``.npz`` and
  ``.pth`` files (sha8, stale hash, descriptive names), its key check,
  the legacy ``.pth`` re-save.
"""

import http.server
import os
import socket
import threading
import urllib.parse
import zipfile

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(rel):
    import importlib.util
    name = '_t_jax_' + rel.replace('/', '_')[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'scripts', rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- memcached
@pytest.fixture()
def fake_memcached():
    """A memcached text-protocol server: 'get' of a stored key, END for a
    miss, SERVER_ERROR for keys starting 'boom', a value cut short for
    'cut'."""
    store = {'img_001': os.urandom(5000), 'hello': b'world', 'cut': b'x' * 9}
    srv = socket.socket()
    srv.bind(('127.0.0.1', 0))
    srv.listen(4)
    conns = []

    def handle(conn):
        with conn:
            buf = b''
            while True:
                try:
                    data = conn.recv(4096)
                except OSError:
                    return
                if not data:
                    return
                buf += data
                while b'\r\n' in buf:
                    line, buf = buf.split(b'\r\n', 1)
                    parts = line.decode().split()
                    if not parts or parts[0] != 'get':
                        conn.sendall(b'ERROR\r\n')
                        continue
                    key = parts[1]
                    if key.startswith('boom'):
                        conn.sendall(b'SERVER_ERROR out of memory\r\n')
                    elif key == 'cut':
                        conn.sendall(b'VALUE cut 0 9\r\nxxx')
                        return
                    elif key in store:
                        v = store[key]
                        conn.sendall(f'VALUE {key} 0 {len(v)}\r\n'.encode()
                                     + v + b'\r\nEND\r\n')
                    else:
                        conn.sendall(b'END\r\n')

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            conns.append(conn)
            threading.Thread(target=handle, args=(conn,), daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    yield store, f'127.0.0.1:{srv.getsockname()[1]}', conns
    srv.close()


def _clients(addr):
    from bsvd_tpu.utils.file_client import FileClient as JaxClient
    from bsvd_tpu_torch.utils.file_client import FileClient
    return (FileClient('memcached', server_list_cfg=addr),
            JaxClient('memcached', server_list_cfg=addr))


def test_memcached_hits_misses_and_server_list(fake_memcached, tmp_path):
    store, addr, conns = fake_memcached
    cfg = tmp_path / 'servers.txt'
    cfg.write_text(f'# memcached servers\n\n{addr}\n127.0.0.1:1\n')
    for cfg_form in (addr, str(cfg)):
        port, jax = _clients(cfg_form)
        for key in ('img_001', 'hello', 'missing', 'img_001'):
            assert port.get(key) == jax.get(key) == store.get(key)
        assert port.get_text('hello') == jax.get_text('hello') == 'world'
        assert port.get_text('nope') is None
    assert len(conns) == 4       # one connection a client


def test_memcached_bad_keys_and_error_replies(fake_memcached):
    store, addr, conns = fake_memcached
    port, jax = _clients(addr)
    for client in (port, jax):
        for key in ('key with space', 'k' * 251, 'a\rb', 'a\nb'):
            with pytest.raises(ValueError, match='invalid memcached key'):
                client.get(key)
        with pytest.raises(ConnectionError, match='SERVER_ERROR'):
            client.get('boom1')
        assert client.client._sock is None
        assert client.get('hello') == b'world'     # a new connection
    assert len(conns) == 4
    with pytest.raises(ConnectionError, match='mid-value'):
        port.get('cut')


# ---------------------------------------------------------------- downloads
@pytest.fixture()
def drive(tmp_path):
    """A local HTTP server: '/uc' as Google Drive answers a large file
    (an HTML page and a download_warning cookie, then the file with
    confirm=<token>; a 206 with Content-Range for a 'Range' request),
    '/files/<name>' as a plain file server. Records each request."""
    files = {'abc': os.urandom(70001), 'small': b'tiny file'}
    zbuf = tmp_path / 'Set5.zip'
    with zipfile.ZipFile(zbuf, 'w') as zf:
        zf.writestr('Set5/baby.png', b'png-bytes')
        zf.writestr('Set5/bird.png', b'bird-bytes')
    files['set5'] = zbuf.read_bytes()
    log = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            log.append((url.path, q, self.headers.get('Range'),
                        self.headers.get('Cookie')))
            if url.path.startswith('/files/'):
                name = url.path[len('/files/'):]
                if name not in files:
                    return self._send(404, b'no')
                return self._send(200, files[name])
            data = files.get(q.get('id'))
            if data is None:
                return self._send(404, b'no such file')
            if q.get('confirm') != 'TOK' + q['id']:
                return self._send(200, b'<html>virus scan warning</html>', [
                    ('Set-Cookie', f'download_warning_1234=TOK{q["id"]}; '
                                   'Path=/')])
            if self.headers.get('Range') == 'bytes=0-2':
                return self._send(206, data[:3], [
                    ('Content-Range', f'bytes 0-2/{len(data)}')])
            self._send(200, data)

    httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield files, f'http://127.0.0.1:{httpd.server_address[1]}', log
    httpd.shutdown()
    httpd.server_close()


def _jax_on(monkeypatch, base):
    """JAX's requests session sent to the local server."""
    import requests
    get = requests.Session.get

    def local(self, url, *a, **kw):
        return get(self, url.replace('https://docs.google.com', base),
                   *a, **kw)
    monkeypatch.setattr(requests.Session, 'get', local)


def test_google_drive_download_equals_jax(drive, tmp_path, monkeypatch,
                                          capsys):
    from bsvd_tpu.utils import download_util as jdu
    from bsvd_tpu_torch.utils import download_util
    files, base, log = drive
    monkeypatch.setattr(download_util, 'GDRIVE_URL',
                        f'{base}/uc?export=download')
    _jax_on(monkeypatch, base)
    download_util.download_file_from_google_drive('abc', str(tmp_path / 'p'))
    port_log, port_out = list(log), capsys.readouterr().out
    del log[:]
    jdu.download_file_from_google_drive('abc', str(tmp_path / 'j'))
    assert (tmp_path / 'p').read_bytes() == (tmp_path / 'j').read_bytes() \
        == files['abc']
    # the same three requests: ask, confirm, the range (cookie sent on)
    assert [e[:3] for e in port_log] == [e[:3] for e in log] == [
        ('/uc', {'export': 'download', 'id': 'abc'}, None),
        ('/uc', {'export': 'download', 'id': 'abc', 'confirm': 'TOKabc'},
         None),
        ('/uc', {'export': 'download', 'id': 'abc', 'confirm': 'TOKabc'},
         'bytes=0-2')]
    assert port_log[1][3] == 'download_warning_1234=TOKabc'
    assert port_out == capsys.readouterr().out
    assert 'Download 68.4 KB / 68.4 KB' in port_out


def test_load_file_from_url_cache_and_errors(drive, tmp_path):
    from bsvd_tpu.utils.download_util import load_file_from_url as jload
    from bsvd_tpu_torch.utils.download_util import load_file_from_url
    files, base, log = drive
    got = load_file_from_url(f'{base}/files/small', str(tmp_path / 'm'))
    want = jload(f'{base}/files/small', str(tmp_path / 'j'))
    assert os.path.basename(got) == os.path.basename(want) == 'small'
    assert open(got, 'rb').read() == open(want, 'rb').read() == b'tiny file'
    n = len(log)
    assert load_file_from_url(f'{base}/files/gone', str(tmp_path / 'm'),
                              file_name='small') == got
    assert len(log) == n                       # cached: no request
    with pytest.raises(OSError):               # urllib's HTTPError
        load_file_from_url(f'{base}/files/gone', str(tmp_path / 'm'))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        closed = s.getsockname()[1]
    with pytest.raises(OSError, match='cannot download'):
        load_file_from_url(f'http://127.0.0.1:{closed}/x.pth',
                           str(tmp_path / 'm'))


def test_save_response_content_takes_a_requests_response(drive, tmp_path):
    import requests
    from bsvd_tpu_torch.utils.download_util import (Session,
                                                    save_response_content)
    files, base, _ = drive
    with requests.get(f'{base}/files/abc', stream=True) as r:
        save_response_content(r, str(tmp_path / 'a'), 70001, 4096)
    with Session().get(f'{base}/files/abc') as r:
        save_response_content(r, str(tmp_path / 'b'), None, 1000)
    assert (tmp_path / 'a').read_bytes() == (tmp_path / 'b').read_bytes() \
        == files['abc']


def test_download_scripts(drive, tmp_path, monkeypatch):
    from bsvd_tpu_torch.scripts import (download_gdrive,
                                        download_pretrained_models as dpm)
    from bsvd_tpu_torch.scripts.data_preparation import download_datasets
    from bsvd_tpu_torch.utils import download_util
    files, base, log = drive
    monkeypatch.setattr(download_util, 'GDRIVE_URL',
                        f'{base}/uc?export=download')
    download_gdrive.main(['--id', 'small', '--output',
                          str(tmp_path / 'one.bin')])
    assert (tmp_path / 'one.bin').read_bytes() == files['small']

    sources = {'a.pth': f'{base}/files/small', 'b.pth': ('gdrive', 'abc')}
    monkeypatch.chdir(tmp_path)
    root = os.path.join('experiments', 'pretrained_models')
    dpm.download_pretrained_models('M', sources)
    assert open(os.path.join(root, 'M', 'a.pth'), 'rb').read() == \
        files['small']
    assert open(os.path.join(root, 'M', 'b.pth'), 'rb').read() == \
        files['abc']
    n = len(log)
    monkeypatch.setattr('builtins.input', lambda *_: 'n')
    dpm.download_pretrained_models('M', sources)
    assert len(log) == n                       # both skipped
    files['small'] = b'newer'
    dpm.download_pretrained_models('M', sources, assume_yes=True)
    assert open(os.path.join(root, 'M', 'a.pth'), 'rb').read() == b'newer'
    assert dpm.SOURCES == _jax_script('download_pretrained_models.py').SOURCES

    monkeypatch.setattr(download_datasets, 'FILE_IDS',
                        {'Set5': {'Set5.zip': 'set5'}})
    download_datasets.main(['Set5'])
    out = tmp_path / 'datasets' / 'Set5'
    assert sorted(os.listdir(out)) == ['baby.png', 'bird.png']
    assert (out / 'bird.png').read_bytes() == b'bird-bytes'
    monkeypatch.setattr('builtins.input', lambda *_: 'maybe')
    with pytest.raises(ValueError, match='Only accepts'):
        download_datasets.main(['Set5'])


def test_unzip_flattens_as_jax(tmp_path):
    from bsvd_tpu_torch.scripts.data_preparation import download_datasets
    jdd = _jax_script('data_preparation/download_datasets.py')
    for side, mod in (('p', download_datasets), ('j', jdd)):
        os.makedirs(tmp_path / side)
        with zipfile.ZipFile(tmp_path / side / 'Set14.zip', 'w') as zf:
            zf.writestr('Set14/a/x.png', b'1')
            zf.writestr('Set14/y.png', b'2')
        mod._unzip(str(tmp_path / side / 'Set14.zip'))
    for side in ('p', 'j'):
        assert sorted(os.listdir(tmp_path / side / 'Set14')) == ['a', 'y.png']


# ----------------------------------------------------------- publish_models
def _checkpoints(folder):
    os.makedirs(folder)
    np.savez(str(folder / 'net_g.npz'), **{'params/stage0/w': np.zeros(3)})
    np.savez(str(folder / 'other-deadbeef.npz'),
             **{'params_ema/x': np.ones(2)})
    np.savez(str(folder / 'bsvd-64.npz'), **{'params.w': np.ones(2)})
    torch.save({'params': {'w': torch.arange(4.0)}}, str(folder / 'a.pth'))
    torch.save({'params_ema': {'w': torch.ones(2)}},
               str(folder / 'b-12345678.pth'),
               _use_new_zipfile_serialization=False)


def test_publish_models_renames_equal_jax(tmp_path, monkeypatch):
    from bsvd_tpu_torch.scripts import publish_models
    jpm = _jax_script('publish_models.py')
    for side in ('p', 'j'):
        _checkpoints(tmp_path / side)
    got = publish_models.main(['--glob', str(tmp_path / 'p' / '*'),
                               '--yes'])
    monkeypatch.setattr('sys.argv', ['publish_models.py', '--glob',
                                     str(tmp_path / 'j' / '*'), '--yes'])
    jpm.main()
    names = sorted(os.listdir(tmp_path / 'p'))
    jnames = sorted(os.listdir(tmp_path / 'j'))
    assert sorted(os.path.basename(p) for p in got) == names
    # a legacy torch.save differs from run to run (its storage keys), so
    # the .pth hashes differ; the .npz files and every name stem agree
    assert [n.rsplit('-', 1)[0] for n in names] == \
        [n.rsplit('-', 1)[0] for n in jnames] == [
            'a', 'b', 'bsvd-64', 'net_g', 'other']
    assert [n for n in names if n.endswith('.npz')] == \
        [n for n in jnames if n.endswith('.npz')]
    for name in names:
        stem, ext = os.path.splitext(name)
        assert stem.rsplit('-', 1)[1] == publish_models.file_sha8(
            str(tmp_path / 'p' / name))
    assert any(n.startswith('bsvd-64-') for n in names)
    assert not any('deadbeef' in n or '12345678' in n for n in names)
    for name in names:
        if name.endswith('.pth'):
            assert not publish_models.zipfile_format(
                str(tmp_path / 'p' / name))
            assert set(torch.load(str(tmp_path / 'p' / name))) & {
                'params', 'params_ema'}
    assert publish_models.update_sha(got, assume_yes=True) == got


def test_publish_models_check_keys(tmp_path, capsys, monkeypatch):
    from bsvd_tpu_torch.scripts import publish_models
    np.savez(str(tmp_path / 'broken.npz'), **{'opt_state/count': np.zeros(1)})
    torch.save({'state_dict': {}}, str(tmp_path / 'broken.pth'))
    for name in ('broken.npz', 'broken.pth'):
        publish_models.check_keys(str(tmp_path / name), assume_yes=True)
        assert 'does not have' in capsys.readouterr().out
    monkeypatch.setattr('builtins.input', lambda *_: 'n')
    with pytest.raises(ValueError, match='Aborted'):
        publish_models.check_keys(str(tmp_path / 'broken.npz'))
    torch.save({'params': {}}, str(tmp_path / 'good.pth'))
    publish_models.check_keys(str(tmp_path / 'good.pth'))
    assert 'does not have' not in capsys.readouterr().out

"""Downloads of models and datasets (counterpart of bsvd_tpu/utils/
download_util.py, BasicSR's utils/download_util): Google Drive files by
id, with the large-file confirmation token, and ``load_file_from_url``
with its cache folder.

Built on ``urllib.request`` and ``http.cookiejar`` (no ``requests``). A
host that cannot be reached raises OSError naming the URL. ``GDRIVE_URL``
is the Drive endpoint; the tests point it at a local server.
"""

import http.cookiejar
import math
import os
import urllib.error
import urllib.parse
import urllib.request

from bsvd_tpu_torch.utils.misc import sizeof_fmt

GDRIVE_URL = 'https://docs.google.com/uc?export=download'


class Response:
    """What the helpers read of an HTTP response: ``headers``,
    ``cookies`` ({name: value} of the session's jar) and
    ``iter_content(chunk_size)``, the body in chunks (as a ``requests``
    response streams it, so ``save_response_content`` takes either)."""

    def __init__(self, raw, cookies):
        self.raw = raw
        self.headers = raw.headers
        self.cookies = cookies

    def iter_content(self, chunk_size=1):
        while True:
            chunk = self.raw.read(chunk_size)
            if not chunk:
                return
            yield chunk

    def close(self):
        self.raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Session:
    """GETs sharing one cookie jar."""

    def __init__(self):
        self.jar = http.cookiejar.CookieJar()
        self._opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(self.jar))

    def get(self, url, params=None, headers=None, timeout=30):
        if params:
            url += ('&' if '?' in url else '?') + urllib.parse.urlencode(
                params)
        req = urllib.request.Request(url, headers=headers or {})
        try:
            raw = self._opener.open(req, timeout=timeout)
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, OSError) as e:
            raise OSError(f'cannot download {url}: '
                          f'{getattr(e, "reason", e)} (no network?)') from e
        return Response(raw, {c.name: c.value for c in self.jar})


def get_confirm_token(response):
    """Google Drive's large-file confirmation token: the value of the
    response's ``download_warning*`` cookie, else None."""
    for key, value in response.cookies.items():
        if key.startswith('download_warning'):
            return value
    return None


def save_response_content(response, destination, file_size=None,
                          chunk_size=32768):
    """A response's body into ``destination`` in ``chunk_size`` chunks,
    printing the progress every 32 chunks and at the last."""
    readable = sizeof_fmt(file_size) if file_size is not None else '?'
    total_chunks = (math.ceil(file_size / chunk_size)
                    if file_size is not None else None)
    downloaded = 0
    with open(destination, 'wb') as f:
        for i, chunk in enumerate(response.iter_content(chunk_size)):
            downloaded += len(chunk)
            if total_chunks and (i % 32 == 0 or i + 1 == total_chunks):
                print(f'Download {sizeof_fmt(downloaded)} / {readable}')
            if chunk:
                f.write(chunk)


def download_file_from_google_drive(file_id, save_path):
    """A Google Drive file by id into ``save_path``: asked once, again with
    the confirmation token where Drive sets one, and its size read from
    the ``Content-Range`` of a 3-byte range request."""
    session = Session()
    params = {'id': file_id}
    response = session.get(GDRIVE_URL, params=params)
    token = get_confirm_token(response)
    if token:
        response.close()
        params['confirm'] = token
        response = session.get(GDRIVE_URL, params=params)
    with session.get(GDRIVE_URL, params=params,
                     headers={'Range': 'bytes=0-2'}) as sized:
        file_size = None
        if 'Content-Range' in sized.headers:
            file_size = int(sized.headers['Content-Range'].split('/')[1])
    with response:
        save_response_content(response, save_path, file_size)


def load_file_from_url(url, model_dir='experiments/pretrained_models',
                       progress=True, file_name=None):
    """``url`` downloaded into ``model_dir`` (under ``file_name``, else
    the URL path's last part) unless the file is there already; returns
    its absolute path."""
    del progress
    os.makedirs(model_dir, exist_ok=True)
    if file_name is None:
        file_name = os.path.basename(urllib.parse.urlparse(url).path)
    cached = os.path.abspath(os.path.join(model_dir, file_name))
    if os.path.exists(cached):
        return cached
    print(f'Downloading: "{url}" to {cached}')
    with Session().get(url) as r:
        size = r.headers.get('Content-Length')
        save_response_content(r, cached, int(size) if size else None)
    return cached

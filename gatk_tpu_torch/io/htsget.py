# Copied verbatim from gatk_tpu/io/htsget.py; only import lines may differ.
"""htsget protocol reads source (GA4GH htsget v1.2).

Reference: tools/htsgetreader/ (HtsgetReader.java) — GATK's HtsgetReader tool
fetches a reads ticket from an htsget endpoint, downloads the ticket's URL
blocks (https and inline data: URIs), concatenates them into a BAM stream, and
exposes the records. This implementation speaks the same protocol with
urllib and feeds the assembled stream to the native BAM reader, so htsget
sources behave like any other reads input.
"""
from __future__ import annotations

import base64
import json
import os
import tempfile
import urllib.parse
import urllib.request


class HtsgetError(RuntimeError):
    pass


def _fetch_url(url: str, headers: dict | None = None) -> bytes:
    if url.startswith("data:"):
        # data:[<mediatype>][;base64],<payload>
        meta, _, payload = url.partition(",")
        if ";base64" in meta:
            return base64.b64decode(payload)
        return urllib.parse.unquote_to_bytes(payload)
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req) as resp:
        return resp.read()


def fetch_reads_ticket(endpoint: str, read_id: str, reference_name: str | None = None,
                       start: int | None = None, end: int | None = None,
                       data_format: str = "BAM") -> dict:
    """GET {endpoint}/reads/{id} with htsget query params; returns the ticket."""
    params = {"format": data_format}
    if reference_name is not None:
        params["referenceName"] = reference_name
        if start is not None:
            params["start"] = str(start)
        if end is not None:
            params["end"] = str(end)
    url = f"{endpoint.rstrip('/')}/reads/{urllib.parse.quote(read_id)}?" \
          + urllib.parse.urlencode(params)
    raw = _fetch_url(url)
    doc = json.loads(raw)
    if "htsget" not in doc:
        raise HtsgetError(f"malformed htsget response from {url}")
    return doc["htsget"]


def download_reads(endpoint: str, read_id: str, output_path: str,
                   reference_name: str | None = None, start: int | None = None,
                   end: int | None = None) -> str:
    """Assemble the ticket's URL blocks into a local BAM file."""
    ticket = fetch_reads_ticket(endpoint, read_id, reference_name, start, end)
    fmt = ticket.get("format", "BAM").upper()
    if fmt != "BAM":
        raise HtsgetError(f"unsupported htsget format {fmt}")
    with open(output_path, "wb") as out:
        for block in ticket.get("urls", []):
            out.write(_fetch_url(block["url"], block.get("headers")))
    return output_path


class HtsgetReader:
    """Reads-source facade over an htsget endpoint: iterate or query()."""

    def __init__(self, endpoint: str, read_id: str):
        self.endpoint = endpoint
        self.read_id = read_id
        self._tmp = None
        self._reader = None

    def _open(self, reference_name=None, start=None, end=None):
        from . import bam as bamio

        fd, path = tempfile.mkstemp(suffix=".bam")
        os.close(fd)
        download_reads(self.endpoint, self.read_id, path, reference_name, start, end)
        if self._tmp and os.path.exists(self._tmp):
            os.unlink(self._tmp)
        self._tmp = path
        self._reader = bamio.BamReader(path)
        return self._reader

    @property
    def header(self):
        if self._reader is None:
            self._open()
        return self._reader.header

    def __iter__(self):
        return iter(self._open())

    def query(self, contig: str, start: int, end: int):
        """Server-side range request (htsget 1-based start per spec uses
        0-based half-open start/end query params)."""
        reader = self._open(reference_name=contig, start=start, end=end)
        for r in reader:
            if r.pos < end and r.end > start:
                yield r

    def close(self):
        if self._tmp and os.path.exists(self._tmp):
            os.unlink(self._tmp)

"""Stream providers: gzip-transparent, byte-counted, URL-or-file inputs.

Reference equivalents: base io/StreamProvider.java (gzip by filename suffix),
io/StreamingResource.java family (uniform file/URL streaming with byte-read
counting feeding progress/throughput logging).
"""

from __future__ import annotations

import gzip
import io
import os
import urllib.request
from pathlib import Path


def is_gzip_name(name: str) -> bool:
    return name.endswith(".gz") or name.endswith(".gzip")


class ByteCountingRaw(io.RawIOBase):
    """Wraps a raw binary stream, counting compressed bytes read."""

    def __init__(self, raw):
        self._raw = raw
        self.bytes_read = 0

    def readable(self):
        return True

    def readinto(self, b):
        n = self._raw.readinto(b)
        if n:
            self.bytes_read += n
        return n

    def close(self):
        self._raw.close()
        super().close()


class StreamingResource:
    """A (re-)streamable input: a local file or a URL, optionally gzipped.

    `type_hint` carries fasta/fastq detection by suffix, mirroring the
    reference's StreamingResource.getTypeHint().
    """

    def __init__(self, source, assume_gzip: bool | None = None, name: str | None = None):
        self.source = str(source)
        self.name = name or os.path.basename(self.source.split("?")[0])
        self.assume_gzip = assume_gzip
        self.counter: ByteCountingRaw | None = None

    @property
    def is_url(self) -> bool:
        return "://" in self.source and not self.source.startswith("file://")

    def size(self) -> int | None:
        if not self.is_url:
            p = self._local_path()
            try:
                return os.path.getsize(p)
            except OSError:
                return None
        return None

    def _local_path(self) -> str:
        if self.source.startswith("file://"):
            return self.source[len("file://"):]
        return self.source

    @property
    def type_hint(self) -> str | None:
        base = self.name
        for gz in (".gz", ".gzip"):
            if base.endswith(gz):
                base = base[: -len(gz)]
        if base.endswith((".fastq", ".fq")):
            return "fastq"
        if base.endswith((".fasta", ".fa", ".fna")):
            return "fasta"
        return None

    def open(self) -> io.BufferedReader:
        """Open for reading, gzip-decompressed if applicable, byte-counted."""
        if self.is_url:
            raw = urllib.request.urlopen(self.source)
            gz = self.assume_gzip if self.assume_gzip is not None else is_gzip_name(self.name)
        else:
            raw = open(self._local_path(), "rb", buffering=0)
            gz = is_gzip_name(self.name)
        self.counter = ByteCountingRaw(raw)
        buffered = io.BufferedReader(self.counter, buffer_size=1 << 20)
        if gz:
            # BGZF (bgzip'd) files decompress in parallel — the inflate is
            # the host pipeline's single-stream ceiling (io/bgzf.py). Only
            # engaged with >2 usable cores: on a 2-core host the pool
            # threads merely contend with the read-ahead + parser threads,
            # while GzipFile reads BGZF fine serially.
            from genestrip_tpu.io.bgzf import is_bgzf_header, open_bgzf
            try:
                ncpu = len(os.sched_getaffinity(0))
            except AttributeError:     # non-Linux
                ncpu = os.cpu_count() or 1
            if ncpu > 2 and is_bgzf_header(buffered.peek(18)[:18]):
                return open_bgzf(buffered, threads=min(ncpu - 2, 8))
            return io.BufferedReader(gzip.GzipFile(fileobj=buffered), buffer_size=1 << 20)
        return buffered

    def __repr__(self):
        return f"StreamingResource({self.source})"


class ReadAhead:
    """Background read-ahead over a binary stream.

    A daemon thread pulls fixed-size chunks into a bounded queue; zlib
    releases the GIL during decompression, so gzip inflate overlaps the
    consumer's parsing on another core (the replacement for the
    reference's dedicated producer thread, ref
    fastq/AbstractFastqReader.java:88-118). Supports read() (any-size
    partial returns) and readline() (for the robust-parser fallback)."""

    def __init__(self, stream, chunk: int = 1 << 22, depth: int = 4):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(depth)
        self._buf = b""
        self._done = False
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(stream, chunk), daemon=True)
        self._thread.start()

    def _run(self, stream, chunk):
        def put_until_closed(item):
            # bounded put that re-checks close, so an abandoned consumer
            # cannot pin the producer (and the underlying file) forever
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return
                except Exception:   # queue.Full
                    continue

        try:
            while not self._closed.is_set():
                c = stream.read(chunk)
                put_until_closed(c)
                if not c:
                    return
        except BaseException as e:     # noqa: BLE001 — re-raised on consumer
            # must use the same blocking put: a put_nowait on a full queue
            # would DROP the error and leave the consumer waiting forever
            put_until_closed(e)

    def close(self) -> None:
        """Stop the producer thread (idempotent); pending chunks are dropped."""
        self._closed.set()
        self._done = True
        # unblock a producer waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _next_chunk(self) -> bytes:
        if self._done:
            return b""
        c = self._q.get()
        if isinstance(c, BaseException):
            self._done = True
            raise c
        if not c:
            self._done = True
        return c

    def read(self, n: int = -1) -> bytes:
        """Read up to n bytes (standard read contract; n <= 0 reads whatever
        buffered/next chunk is available, like a raw stream's read1)."""
        if not self._buf:
            self._buf = self._next_chunk()
        if n is None or n < 0 or n >= len(self._buf):
            out, self._buf = self._buf, b""
            return out
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def readline(self) -> bytes:
        parts = []
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = self._buf[: i + 1]
                self._buf = self._buf[i + 1:]
                parts.append(line)
                return b"".join(parts)
            if self._buf:
                parts.append(self._buf)
                self._buf = b""
            c = self._next_chunk()
            if not c:
                return b"".join(parts)
            self._buf = c


def open_input(path) -> io.BufferedReader:
    """Gzip-transparent buffered input stream for a file path."""
    return StreamingResource(path).open()


def open_output(path):
    """Gzip-transparent buffered output stream by filename suffix
    (ref: StreamProvider.getOutputStreamForFile)."""
    path = str(path)
    if is_gzip_name(path):
        # Stable bytes: fixed mtime so identical content => identical file.
        return gzip.GzipFile(path, "wb", compresslevel=5, mtime=0)
    return open(path, "wb", buffering=1 << 20)


def resources_from_paths(paths, assume_gzip_urls: bool = True) -> list[StreamingResource]:
    out = []
    for p in paths:
        if isinstance(p, StreamingResource):
            out.append(p)
        else:
            s = str(p)
            gz = None
            if "://" in s and assume_gzip_urls:
                gz = True
            out.append(StreamingResource(s, assume_gzip=gz))
    return out


class Progress:
    """Throttled progress/throughput logging bound to a byte-counted resource.

    Reference equivalent: the per-file progress of
    fastq/AbstractLoggingFastqStreamer.java:95-140 and the byte-counting bars
    of base util/progressbar/GSProgressBarCreator.java:71 — rendered as log
    lines (units done, MB read, percent, units/s, ETA) instead of a TTY bar.
    """

    def __init__(self, task: str, resource: StreamingResource | None = None,
                 enabled: bool = True, interval_ms: int = 1000,
                 unit: str = "reads"):
        import logging
        import time as _time
        self._log = logging.getLogger("genestrip")
        self.task = task
        self.resource = resource
        self.enabled = enabled and self._log.isEnabledFor(logging.INFO)
        self.interval = max(interval_ms, 100) / 1000.0
        self.unit = unit
        self._time = _time
        self.units = 0
        self.size = resource.size() if resource is not None else None
        self.t0 = _time.time()
        self._last = self.t0
        if self.enabled:
            name = resource.name if resource is not None else ""
            self._log.info("%s: started %s", task, name)

    def update(self, units: int) -> None:
        self.units += units
        if not self.enabled:
            return
        now = self._time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        el = max(now - self.t0, 1e-9)
        rate = self.units / el
        msg = f"{self.task}: {self.units} {self.unit} ({rate:,.0f}/s)"
        if self.resource is not None and self.resource.counter is not None:
            br = self.resource.counter.bytes_read
            msg += f", {br / 1e6:.1f} MB"
            if self.size:
                frac = min(br / self.size, 1.0)
                if frac > 0:
                    eta = el * (1 - frac) / frac
                    msg += f" ({frac * 100:.0f}%, ETA {eta:.0f}s)"
        self._log.info(msg)

    def done(self) -> None:
        if not self.enabled:
            return
        el = max(self._time.time() - self.t0, 1e-9)
        self._log.info(f"{self.task}: done — {self.units} {self.unit} in "
                       f"{el:.1f}s ({self.units / el:,.0f} {self.unit}/s)")

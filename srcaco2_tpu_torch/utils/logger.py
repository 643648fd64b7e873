"""Structured experiment logging (port of srcaco2_tpu/utils/logger.py):
a process-global logger with stdout, text (log.txt) and JSON-lines
(log.json) backends; non-master processes log nothing.
"""
import json
import os
import sys
import time
import atexit
from typing import Optional


class _Backend:
    def log(self, msg: str):  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass


class StdOutBackend(_Backend):
    def log(self, msg: str):
        print(msg, flush=True)


class TextFileBackend(_Backend):
    def __init__(self, path: str):
        self._f = open(path, 'a')

    def log(self, msg: str):
        self._f.write(msg + '\n')

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class JsonFileBackend(_Backend):
    """Timestamped JSON-lines, appended across resumes (reference:
    dllogger ArbJSONStreamBackend)."""

    def __init__(self, path: str):
        self._f = open(path, 'a')

    def log(self, msg: str):
        rec = {'ts': time.time(),
               'datetime': time.strftime('%Y-%m-%d %H:%M:%S'),
               'msg': msg}
        self._f.write(json.dumps(rec) + '\n')

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class _DLLogger:
    def __init__(self):
        self._backends = []
        self._is_master = True
        self._initialized = False
        self._flush_each = True

    def init(self, outdir: Optional[str] = None, is_master: bool = True,
             verbose: bool = True, filename: str = 'log',
             flush_each: bool = True):
        self.reset()
        self._is_master = is_master
        self._flush_each = flush_each
        if not is_master:
            self._initialized = True
            return
        if verbose:
            self._backends.append(StdOutBackend())
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            self._backends.append(
                TextFileBackend(os.path.join(outdir, f'{filename}.txt')))
            self._backends.append(
                JsonFileBackend(os.path.join(outdir, f'{filename}.json')))
        self._initialized = True
        atexit.register(self.flush)

    def reset(self):
        for b in self._backends:
            b.flush()
            b.close()
        self._backends = []
        self._initialized = False

    def log(self, msg):
        if not self._is_master:
            return
        if not self._initialized:
            print(msg, flush=True)
            return
        msg = str(msg)
        for b in self._backends:
            b.log(msg)
            if self._flush_each:
                b.flush()

    def flush(self):
        for b in self._backends:
            b.flush()


# process-global singleton, reference-style usage: DLLogger.log('...')
DLLogger = _DLLogger()


def fmsg(msg: str, upper: bool = False) -> str:
    """Frame a message for visibility (reference: tools.fmsg)."""
    m = msg.upper() if upper else msg
    line = '=' * max(10, min(80, len(m) + 8))
    return f'\n{line}\n    {m}\n{line}'

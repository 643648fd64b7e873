"""YAML files without a hard dependency on PyYAML.

The JAX package writes its configs (`config.yml`, `config_final.yml`,
`config_model.yml`) and the per-image dumps (`details_*.yml`,
`summary_*.yaml`) with `yaml.safe_dump`, and reads them with
`yaml.safe_load`. The port does the same where PyYAML imports. Where it
does not, `dump` writes the same dict as JSON under the same name,
which YAML reads too, and `load` reads it back with `json`. Three differences between the grammars are handled:
  * PyYAML reads `1e-05` (no dot in the mantissa) as a string, and
    `json.dumps(1e-5)` prints exactly that: every float is written with
    a dot (`1.0e-05`);
  * non-finite floats are written as YAML writes them (`.inf`, `-.inf`,
    `.nan`) and mapped back to floats on reading;
  * int keys (ProSR's level_config, keyed by scale) are written as JSON
    strings and read back as ints: a key that is an integer's decimal
    form is an int.
"""
import json
import math
import re

try:
    import yaml
except ImportError:
    yaml = None

_NONFINITE = re.compile(r'(?<=[\[:,\s])(-?)\.(inf|nan)(?=[\],\s}]|$)')


def _float(v: float) -> str:
    if math.isnan(v):
        return '.nan'
    if math.isinf(v):
        return '.inf' if v > 0 else '-.inf'
    r = repr(v)
    mant, e, exp = r.partition('e')
    if '.' not in mant:
        mant += '.0'
    return mant + e + exp


def to_json(obj, indent: int = 0) -> str:
    """`obj` (dicts with str keys, lists, tuples, str, int, float, bool,
    None) as JSON text that yaml.safe_load reads back equal."""
    pad = '  ' * (indent + 1)
    if isinstance(obj, dict):
        if not obj:
            return '{}'
        items = []
        for k in sorted(obj, key=str):
            if isinstance(k, bool) or not isinstance(k, (str, int)):
                raise TypeError(f'key {k!r}: only str and int keys are '
                                'written')
            items.append(f'{pad}{json.dumps(str(k))}: '
                         f'{to_json(obj[k], indent + 1)}')
        return '{\n' + ',\n'.join(items) + '\n' + '  ' * indent + '}'
    if isinstance(obj, (list, tuple)):
        return '[' + ', '.join(to_json(v, indent + 1) for v in obj) + ']'
    if obj is None or isinstance(obj, (bool, str)):
        return json.dumps(obj)
    if isinstance(obj, int):
        return str(int(obj))
    if isinstance(obj, float):
        return _float(obj)
    raise TypeError(f'{type(obj).__name__} is not written: {obj!r}')


def dump(obj, path: str) -> None:
    """yaml.safe_dump(obj) to `path`, or its JSON form without PyYAML."""
    with open(path, 'w') as f:
        if yaml is not None:
            yaml.safe_dump(obj, f)
        else:
            f.write(to_json(obj) + '\n')


_INT_KEY = re.compile(r'-?[0-9]+')


def _int_keys(pairs):
    return {int(k) if _INT_KEY.fullmatch(k) else k: v for k, v in pairs}


def loads(text: str):
    """yaml.safe_load(text), or json for the files `dump` writes without
    PyYAML (its int keys read back as ints)."""
    if yaml is not None:
        return yaml.safe_load(text)
    text = _NONFINITE.sub(
        lambda m: m.group(1) + ('Infinity' if m.group(2) == 'inf'
                                else 'NaN'), text)
    return json.loads(text, object_pairs_hook=_int_keys)


def load(path: str):
    with open(path) as f:
        return loads(f.read())


def parse_value(raw: str):
    """A list or dict given on the command line (`--swinir_depths
    "[2, 2]"`), as the JAX parser reads it with yaml.safe_load."""
    if yaml is not None:
        return yaml.safe_load(raw)
    return json.loads(raw, object_pairs_hook=_int_keys)

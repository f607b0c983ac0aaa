# Copy of i3rc_tpu/utils/namelist.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Fortran-namelist configuration reader.

The reference's drivers are configured through Fortran namelist files
(Example-Drivers/monteCarloDriver.f95:90-103, planeParallel.f95:56-112;
Readme.txt:124-129).  This parser reads those same ``.nml`` files so the
shipped configurations are drop-in usable with the TPU drivers.

Supported syntax: ``&group ... /`` blocks, ``name = value`` with scalars,
comma/space-separated arrays, indexed assignment ``name(i) = v``, Fortran
logicals (``.true.``/``.false.``/``T``/``F``), quoted strings, ``!``
comments, and repeat counts (``3*0.``).
"""

from __future__ import annotations

import re


def _convert_token(tok: str):
    t = tok.strip()
    low = t.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    if (t.startswith("'") and t.endswith("'")) or (t.startswith('"') and t.endswith('"')):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        # Fortran double-precision exponents use d/D
        return float(low.replace("d", "e"))
    except ValueError:
        pass
    return t


def _tokenize_values(text: str):
    """Split a namelist value string into tokens, honoring quotes, Fortran
    complex literals (re, im), and repeat counts (n*value)."""
    tokens = []
    for m in re.finditer(r"'[^']*'|\"[^\"]*\"|\([^()]*,[^()]*\)|[^,\s]+", text):
        tok = m.group(0)
        cm = re.match(r"^\(\s*([^,\s]+)\s*,\s*([^,\s]+)\s*\)$", tok)
        if cm:
            tokens.append(complex(float(cm.group(1).lower().replace("d", "e")),
                                  float(cm.group(2).lower().replace("d", "e"))))
            continue
        rep = re.match(r"^(\d+)\*(.+)$", tok)
        if rep:
            tokens.extend([_convert_token(rep.group(2))] * int(rep.group(1)))
        else:
            tokens.append(_convert_token(tok))
    return tokens


def _strip_comments(line: str) -> str:
    out = []
    in_quote = None
    for ch in line:
        if in_quote:
            if ch == in_quote:
                in_quote = None
            out.append(ch)
        elif ch in ("'", '"'):
            in_quote = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def parse_namelist(text: str) -> dict:
    """Parse namelist text into {group: {name: value}} (group/name lowercase).

    Scalar assignments give scalars; multi-value assignments give lists.
    Indexed assignments ``a(2) = v`` produce a dict {index: value} unless the
    variable already holds a list (then it is set in place, 1-based).
    """
    groups: dict = {}
    # Flatten to a single stream, then split into &group ... / blocks.
    stream = "\n".join(_strip_comments(l) for l in text.splitlines())
    for block in re.finditer(r"&(\w+)(.*?)(?:^|\s)/", stream, re.DOTALL | re.MULTILINE):
        gname = block.group(1).lower()
        body = block.group(2)
        group = groups.setdefault(gname, {})
        # Split into assignments: name [(idx)] = values...
        assigns = list(re.finditer(r"([A-Za-z]\w*)\s*(\(\s*\d+\s*\))?\s*=", body))
        for i, m in enumerate(assigns):
            name = m.group(1).lower()
            idx = m.group(2)
            vstart = m.end()
            vend = assigns[i + 1].start() if i + 1 < len(assigns) else len(body)
            values = _tokenize_values(body[vstart:vend])
            if idx is not None:
                index = int(idx.strip("() "))
                slot = group.setdefault(name, {})
                if isinstance(slot, dict):
                    slot[index] = values[0] if len(values) == 1 else values
                elif isinstance(slot, list):
                    while len(slot) < index:
                        slot.append(None)
                    slot[index - 1] = values[0]
            else:
                group[name] = values[0] if len(values) == 1 else values
    return groups


def read_namelist(path: str) -> dict:
    with open(path) as f:
        return parse_namelist(f.read())

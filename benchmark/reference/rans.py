"""A NumPy decoder of CompressAI's rANS streams (ryg_rans rans64: 64-bit
state, 32-bit renormalization words, 16-bit CDF precision; a symbol past
its row's range is the row's last slot followed by 4-bit bypass nibbles:
counts of 15 and a remainder, then the nibbles, least significant first,
of raw = -2v - 1 below the range and 2(v - max) above it).

`decode` decodes many independent streams in lockstep, one symbol of
every stream a step, so its cost is the length of one stream in NumPy
steps whatever the number of streams.

Where the row of a symbol is not certain (a Gaussian scale that lies so
close to a bucket edge that the coder's own arithmetic may have put it in
the next bucket), `decode` takes two candidate rows and keeps the one
under which the next `LOOKAHEAD` symbols agree best with the symbols
expected there: a wrong row leaves the state wrong, and what follows
decodes to noise.
"""

from __future__ import annotations

import numpy as np

PRECISION = 16
RANS_L = 1 << 31
SPAN = 1 << PRECISION
LOOKAHEAD = 16


class Table:
    """Slot, frequency and start of every cumulative value of every row:
    a decode step is three lookups."""

    def __init__(self, cdf, cdf_length, offset):
        cdf = np.asarray(cdf, np.int64)
        rows = cdf.shape[0]
        self.offset = np.asarray(offset, np.int64)
        self.max_slot = np.asarray(cdf_length, np.int64) - 2
        cum = np.arange(SPAN)
        slot = np.empty((rows, SPAN), np.int64)
        for r in range(rows):
            n = int(cdf_length[r])
            slot[r] = np.searchsorted(cdf[r, :n], cum, side="right") - 1
        start = np.take_along_axis(cdf, slot, 1)
        freq = np.take_along_axis(cdf, slot + 1, 1) - start
        self.slot = slot.reshape(-1)
        self.freq = freq.astype(np.uint64).reshape(-1)
        self.base = (cum[None, :] - start).astype(np.uint64).reshape(-1)


class _Lane:
    """One stream's decoder state, in Python integers."""

    def __init__(self, words, x, ptr):
        self.words, self.x, self.ptr = words, int(x), int(ptr)

    def _renorm(self):
        if self.x < RANS_L:
            w = int(self.words[self.ptr]) if self.ptr < len(self.words) else 0
            self.x = (self.x << 32) | w
            self.ptr += 1

    def _bits(self):
        val = self.x & 15
        self.x >>= 4
        self._renorm()
        return val

    def step(self, row: int, table: Table) -> int:
        k = row * SPAN + (self.x & (SPAN - 1))
        s = int(table.slot[k])
        self.x = int(table.freq[k]) * (self.x >> PRECISION) + int(table.base[k])
        self._renorm()
        top = int(table.max_slot[row])
        if s == top:
            val = self._bits()
            count = val
            while val == 15:
                val = self._bits()
                count += val
            raw = 0
            for j in range(count):
                nib = self._bits()
                if j < 8:
                    raw |= nib << (4 * j)
            s = -(raw >> 1) - 1 if raw & 1 else (raw >> 1) + top
        return s + int(table.offset[row])


def _words(streams):
    n = max(len(s) for s in streams) // 4 + 2
    out = np.zeros((len(streams), n), np.uint64)
    for i, s in enumerate(streams):
        w = np.frombuffer(s, dtype="<u4")
        out[i, :len(w)] = w
    return out


def decode(streams, rows: np.ndarray, table: Table, alt_rows=None,
           expected=None) -> np.ndarray:
    """streams: L byte strings; rows: (L, n) CDF row of each symbol;
    `alt_rows` (L, n), where it differs from `rows`, the other candidate
    row, chosen between by `expected` (L, n) symbols. Returns the (L, n)
    int64 symbols."""
    rows = np.asarray(rows, np.int64)
    L, n = rows.shape
    words = _words(streams)
    lanes = np.arange(L)
    x = (words[:, 1] << np.uint64(32)) | words[:, 0]
    ptr = np.full(L, 2, np.int64)
    rows_t = rows.T.copy()  # (n, L)
    open_t = np.zeros(n, bool)
    if alt_rows is not None:
        alt_t = np.asarray(alt_rows, np.int64).T.copy()
        doubt = alt_t != rows_t
        open_t = doubt.any(1)
        exp_t = np.asarray(expected, np.int64).T
    keys_t = rows_t * SPAN
    top_t = table.max_slot[rows_t]
    off_t = table.offset[rows_t]
    out = np.empty((n, L), np.int64)
    mask, shift = np.uint64(SPAN - 1), np.uint64(PRECISION)
    low_bound, w32 = np.uint64(RANS_L), np.uint64(32)

    for t in range(n):
        r, key, top, off = rows_t[t], keys_t[t], top_t[t], off_t[t]
        if open_t[t]:
            r = r.copy()
            for lane in np.nonzero(doubt[t])[0]:
                r[lane] = _choose(words[lane], x[lane], ptr[lane], t, lane,
                                  (r[lane], alt_t[t, lane]), rows_t, alt_t,
                                  doubt, exp_t, table)
            key, top, off = r * SPAN, table.max_slot[r], table.offset[r]
        k = key + (x & mask).astype(np.int64)
        s = table.slot[k]
        x = table.freq[k] * (x >> shift) + table.base[k]
        low = x < low_bound
        if low.any():
            x[low] = (x[low] << w32) | words[lanes[low], ptr[low]]
            ptr[low] += 1
        val = s + off
        esc = s == top
        if esc.any():
            for lane in np.nonzero(esc)[0]:
                val[lane] = _escape_tail(words[lane], x, ptr, lane,
                                         int(r[lane]), table)
        out[t] = val
    return out.T


def _escape_tail(words, x, ptr, lane, row, table):
    """The value of an escaped symbol whose slot was just decoded: read
    its bypass nibbles from the lane's state (updated in place)."""
    st = _Lane(words, x[lane], ptr[lane])
    val = st._bits()
    count = val
    while val == 15:
        val = st._bits()
        count += val
    raw = 0
    for j in range(count):
        nib = st._bits()
        if j < 8:
            raw |= nib << (4 * j)
    x[lane], ptr[lane] = np.uint64(st.x), st.ptr
    top = int(table.max_slot[row])
    s = -(raw >> 1) - 1 if raw & 1 else (raw >> 1) + top
    return s + int(table.offset[row])


def _choose(words, x, ptr, t, lane, candidates, rows_t, alt_t, doubt,
            exp_t, table):
    """The candidate row for symbol t under which the symbols t..t+15
    decode most like the expected ones (the first on a tie); a later
    symbol in doubt within those is weighed both ways too."""
    end = min(rows_t.shape[0], t + LOOKAHEAD)
    best, best_hits = candidates[0], -1
    for cand in candidates:
        hits = _hits(words, x, ptr, t, end, int(cand), lane, rows_t, alt_t,
                     doubt, exp_t, table, depth=2)
        if hits > best_hits:
            best, best_hits = cand, hits
    return best


def _hits(words, x, ptr, t, end, row, lane, rows_t, alt_t, doubt, exp_t,
          table, depth):
    st = _Lane(words, x, ptr)
    hits = 0
    for j in range(t, end):
        if j > t:
            row = int(rows_t[j, lane])
            if depth and doubt[j, lane]:
                return hits + max(
                    _hits(words, st.x, st.ptr, j, end, int(c), lane, rows_t,
                          alt_t, doubt, exp_t, table, depth - 1)
                    for c in (rows_t[j, lane], alt_t[j, lane]))
        hits += st.step(row, table) == exp_t[j, lane]
    return hits

"""STROBE-128: the duplex construction under Merlin.

Upstream counterpart: merlin/src/strobe.rs (a minimal STROBE-128 with only the
ops Merlin needs: meta-AD, AD, PRF, KEY).  Rate R = 166 bytes over Keccak-f[1600].
Bit-exact parity with upstream is pinned by the Merlin known-answer test.
The port's transcripts run on native.NativeStrobe128 (native/strobe.cpp);
this pure-Python Strobe128 is its twin, with the same interface.
"""

from .keccak import keccak_f1600_bytes

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = Strobe128.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # -- sponge primitives -------------------------------------------------
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes):
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "cannot continue a different op"
            return
        assert flags & FLAG_T == 0, "transport ops not implemented (as upstream)"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = flags & (FLAG_C | FLAG_K) != 0
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops (the Merlin subset) ------------------------------------
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    # -- Merlin's framing (native.NativeStrobe128 fuses each into one call)
    def append_message(self, label: bytes, message: bytes):
        self.meta_ad(label, False)
        self.meta_ad(len(message).to_bytes(4, "little"), True)
        self.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.meta_ad(label, False)
        self.meta_ad(n.to_bytes(4, "little"), True)
        return self.prf(n, False)

    def state_bytes(self) -> bytes:
        """state[200], pos, pos_begin, cur_flags (the native state's layout)."""
        return bytes(self.state) + bytes([self.pos, self.pos_begin,
                                          self.cur_flags])

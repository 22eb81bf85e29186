"""Encrypted, mutually-authenticated peer channel ("cybershake" role).

The port's copy of the JAX package's chain/p2p.py, with the same wire
bytes, so a port peer and a JAX peer complete a handshake and open each
other's frames.  Every group operation on a secret scalar runs on the
engine, constant-time on the card: the ephemeral E = e·B is
Engine.basepoint_mul (the fixed-base kernel K17), each Diffie-Hellman
product is Engine.msm_secret over one point (the constant-time MSM K18),
and the signatures are the port's starsig on the same engine.  The frames
run on the native STROBE (native.NativeStrobe128).

Upstream counterpart: slingshot/p2p/src/* — the cybershake handshake
(curve25519 key agreement + authenticated framing) that carries the node's
block-sync protocol between peers.  This is a role-parity re-design on this
stack's own primitives, not a wire-compatible port (the upstream repo is a
migration tombstone, and there is no live peer to interoperate with):

  * Identity: starsig keypairs (crypto/starsig.py), the same scheme that
    signs transactions.
  * Handshake: Noise-XX-shaped triple DH over Ristretto — ephemeral-
    ephemeral, ephemeral-static both ways — keyed into a Merlin transcript
    (the whole session is one STROBE protocol, so key derivation,
    channel binding, and mutual authentication all fall out of transcript
    discipline); each side proves identity with a starsig over the
    handshake transcript.
  * Framing: per-direction STROBE duplex — PRF-keystream encryption with a
    16-byte PRF MAC over the absorbed ciphertext, state ratcheting every
    frame (forward security within a session).

`SecurePeer.handshake` runs the handshake over any blocking send/recv pair
(in-memory duplex, TCP socket); `encrypted_sync` drives chain/node.py's
block-sync message loop through two authenticated channels end-to-end.
"""

from __future__ import annotations

import os
import queue
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..constants import L
from ..crypto import starsig
from ..native import NativeStrobe128
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine
from ..vm.errors import VMError

PROTOCOL_LABEL = b"zkvm-tpu.cybershake.v1"
MAC_LEN = 16
HANDSHAKE_TIMEOUT_S = 30


class HandshakeError(Exception):
    pass


class ChannelError(Exception):
    pass


@dataclass
class PeerIdentity:
    secret: int
    public: starsig.VerificationKey

    @staticmethod
    def generate(rng=None, device=None,
                 engine: Engine | None = None) -> "PeerIdentity":
        """A random identity, its key x·B on the engine (K17 on the
        card)."""
        x = (scalar.from_bytes_mod_order_wide(os.urandom(64))
             if rng is None else rng.random_scalar())
        return PeerIdentity(x, starsig.VerificationKey.from_secret(
            x, resolve_engine(device, engine)))


def _dh(secret: int, point_bytes: bytes, engine: Engine) -> bytes:
    """secret · P for the encoding P, constant-time in the secret on the
    engine (msm_secret: K18 on the card).  Raises ValueError on an invalid
    encoding."""
    p = RistrettoPoint.decompress(point_bytes)
    return engine.msm_secret([secret % L], [p]).compress()


class SecureChannel:
    """One direction of the encrypted session: STROBE duplex framing.

    Each frame: 4-byte LE length (authenticated as meta), PRF-keystream
    ciphertext, 16-byte MAC.  The strobe state ratchets per frame, so a
    tampered or reordered frame poisons the channel permanently."""

    def __init__(self, strobe: NativeStrobe128):
        self._s = strobe
        self._dead = False

    def seal(self, plaintext: bytes) -> bytes:
        if self._dead:
            raise ChannelError("channel poisoned by earlier failure")
        self._s.meta_ad(struct.pack("<I", len(plaintext)), False)
        ks = self._s.prf(len(plaintext), False)
        ct = bytes(a ^ b for a, b in zip(plaintext, ks))
        self._s.ad(ct, False)
        mac = self._s.prf(MAC_LEN, False)
        return struct.pack("<I", len(ct)) + ct + mac

    def open(self, frame: bytes) -> bytes:
        if self._dead:
            raise ChannelError("channel poisoned by earlier failure")
        if len(frame) < 4 + MAC_LEN:
            self._dead = True
            raise ChannelError("short frame")
        (n,) = struct.unpack("<I", frame[:4])
        if len(frame) != 4 + n + MAC_LEN:
            self._dead = True
            raise ChannelError("frame length mismatch")
        ct, mac = frame[4: 4 + n], frame[4 + n:]
        self._s.meta_ad(struct.pack("<I", n), False)
        ks = self._s.prf(n, False)
        pt = bytes(a ^ b for a, b in zip(ct, ks))
        self._s.ad(ct, False)
        if self._s.prf(MAC_LEN, False) != mac:
            self._dead = True
            raise ChannelError("MAC check failed")
        return pt


class SecurePeer:
    """An authenticated encrypted session with one remote peer."""

    def __init__(self, identity: PeerIdentity, peer_key: bytes,
                 tx: SecureChannel, rx: SecureChannel):
        self.identity = identity
        self.peer_key = peer_key  # compressed verification key, authenticated
        self._tx = tx
        self._rx = rx

    # ---------------------------------------------------------- handshake
    @staticmethod
    def handshake(identity: PeerIdentity, send, recv, initiator: bool,
                  device=None, engine: Engine | None = None) -> "SecurePeer":
        """Run the mutual-auth handshake over blocking send(bytes)/
        recv() -> bytes callables; returns the established session.  Every
        group operation runs on the engine (`engine`, else a TorchEngine on
        `device`, else the card), those on secret scalars constant-time.

        Message flow (both directions symmetric):
          1. X (static vk, 32B) || E (ephemeral, 32B) || nonce (16B)
          2. starsig(handshake transcript)  — after keys are derived
        """
        eng = resolve_engine(device, engine)
        e = scalar.from_bytes_mod_order_wide(os.urandom(64))
        E = eng.basepoint_mul(e).compress()
        nonce = os.urandom(16)
        hello = identity.public.point + E + nonce
        send(hello)
        peer_hello = recv()
        if len(peer_hello) != 80:
            raise HandshakeError("bad hello length")
        peer_X, peer_E, peer_nonce = (
            peer_hello[:32], peer_hello[32:64], peer_hello[64:]
        )

        # transcript binds roles, identities, ephemerals, nonces
        t = Transcript(PROTOCOL_LABEL)
        ha, hb = (hello, peer_hello) if initiator else (peer_hello, hello)
        t.append_message(b"initiator", ha)
        t.append_message(b"responder", hb)

        # triple DH: ee, and ephemeral-static both ways (ordered by role so
        # both sides absorb identical bytes).  Invalid encodings are a
        # handshake failure, not a crash.
        try:
            dh_ee = _dh(e, peer_E, eng)
            if initiator:
                dh_a = _dh(e, peer_X, eng)                # e_i * X_r
                dh_b = _dh(identity.secret, peer_E, eng)  # x_i * E_r
            else:
                dh_a = _dh(identity.secret, peer_E, eng)
                dh_b = _dh(e, peer_X, eng)
        except ValueError as exc:
            raise HandshakeError(f"invalid peer point encoding: {exc}")
        t.append_message(b"dh-ee", dh_ee)
        t.append_message(b"dh-es", dh_a)
        t.append_message(b"dh-se", dh_b)

        # mutual authentication: each side signs the shared transcript
        # TAGGED WITH ITS OWN ROLE — without the role tag a reflection
        # attacker could replay the initiator's hello+signature back at it
        # (identical transcript, identical DH when ha == hb)
        my_role = b"initiator" if initiator else b"responder"
        peer_role = b"responder" if initiator else b"initiator"

        def _role_view(role: bytes) -> Transcript:
            tc = t.clone()
            tc.append_message(b"sign-role", role)
            return tc

        sig = starsig.sign(_role_view(my_role), identity.secret, engine=eng)
        send(sig.to_bytes())
        try:
            peer_sig = starsig.Signature.from_bytes(recv())
            starsig.verify(peer_sig, _role_view(peer_role),
                           starsig.VerificationKey(peer_X), engine=eng)
        except (VMError, ValueError, queue.Empty) as exc:
            raise HandshakeError(f"peer authentication failed: {exc!r}")
        # absorb signatures in ROLE order (initiator first) so both sides'
        # transcript states agree before key derivation
        sig_i, sig_r = ((sig, peer_sig) if initiator else (peer_sig, sig))
        t.append_message(b"sig-initiator", sig_i.to_bytes())
        t.append_message(b"sig-responder", sig_r.to_bytes())

        # per-direction channel keys squeezed from the transcript
        k_i2r = t.challenge_bytes(b"key-i2r", 32)
        k_r2i = t.challenge_bytes(b"key-r2i", 32)

        def channel(key: bytes) -> SecureChannel:
            s = NativeStrobe128(PROTOCOL_LABEL + b".frame")
            s.key(key, False)
            return SecureChannel(s)

        tx, rx = ((channel(k_i2r), channel(k_r2i)) if initiator
                  else (channel(k_r2i), channel(k_i2r)))
        return SecurePeer(identity, peer_X, tx, rx)

    # ---------------------------------------------------------- messaging
    def seal(self, msg: bytes) -> bytes:
        return self._tx.seal(msg)

    def open(self, frame: bytes) -> bytes:
        return self._rx.open(frame)


def duplex_pair():
    """In-memory blocking duplex for tests/single-process nodes; a recv
    waits at most HANDSHAKE_TIMEOUT_S, then raises queue.Empty."""
    q_ab: queue.Queue = queue.Queue()
    q_ba: queue.Queue = queue.Queue()
    a = (q_ab.put, lambda: q_ba.get(timeout=HANDSHAKE_TIMEOUT_S))
    b = (q_ba.put, lambda: q_ab.get(timeout=HANDSHAKE_TIMEOUT_S))
    return a, b


def encrypted_sync(requester, responder, id_req: PeerIdentity,
                   id_resp: PeerIdentity, max_rounds: int = 32) -> int:
    """chain/node.py block-sync driven through two authenticated channels:
    the encrypted-transport twin of chain.node.sync (every protocol message
    rides a sealed frame).  The two handshakes run in two threads, each on
    its node's engine; an error in either is raised here.  Returns the
    number of message rounds."""
    (send_a, recv_a), (send_b, recv_b) = duplex_pair()
    with ThreadPoolExecutor(2) as ex:
        f_req = ex.submit(SecurePeer.handshake, id_req, send_a, recv_a, True,
                          engine=requester.engine)
        f_resp = ex.submit(SecurePeer.handshake, id_resp, send_b, recv_b,
                           False, engine=responder.engine)
        preq = f_req.result(2 * HANDSHAKE_TIMEOUT_S)
        presp = f_resp.result(2 * HANDSHAKE_TIMEOUT_S)

    rounds = 0
    outbound = [requester.start_sync()]
    while outbound and rounds < max_rounds:
        rounds += 1
        replies: list[bytes] = []
        for msg in outbound:
            sealed = preq.seal(msg)            # requester -> responder
            replies.extend(responder.handle_message(presp.open(sealed)))
        outbound = []
        for msg in replies:
            sealed = presp.seal(msg)           # responder -> requester
            outbound.extend(requester.handle_message(preq.open(sealed)))
    if outbound:
        from .node import NodeError
        raise NodeError("sync did not converge")
    return rounds

"""Fitted VT (Mueller-Vingron) evolutionary chain (data module).

Port of ``pyopal_tpu/_vtml_chain.py``, copied unchanged.

The VTML family is generated from a single continuous-time reversible
Markov chain evaluated at different distances (Mueller & Vingron 2000,
J. Comput. Biol. 7:761-776).  The published family is represented in
this tree by one anchor, VTML80 (transcribed in
`pyopal_tpu.matrices`, the table the reference's own test suite uses:
upstream PyOpal ``src/pyopal/tests/test_aligner.py:10-18``).  This
module stores a reversible generator recovered from that anchor by
constrained fitting (experiments/fit_vtml2.py + gen_vtml_chain.py):
every integer of VTML80's 20x20 block pins the chain's exact
distance-80 log-odds into the half-unit rounding interval, and the
stationary frequencies and scale are part of the fit (the recovered
frequencies land on realistic amino-acid abundances).

`vtml_scores(n)` therefore regenerates VTML80's 20x20 block
bit-exactly (asserted by tests/test_matrices.py); matrices at OTHER
distances are this chain's extrapolations.  With only one published
anchor available offline they cannot be certified equal to
Mueller-Vingron's own tables at those distances — they are the same
construction (one chain, many distances) from a chain consistent with
the anchor.  B/Z/X rows of generated tables use the score-average
rule and the star penalty is ``block_min - 2`` (both chosen to match
the bundled VTML80's conventions as far as they are derivable; the
published VTML80's B/Z/X rows follow no derivation rule that is
jointly feasible with the chain constraints, so VTML80 itself is
always served from the transcription, never from the chain).

Stored form: the symmetric generator flux ``psi[i][j] = f_j * Q[i][j]``
(strict upper triangle, hex floats), the stationary frequencies, and
the score scale lambda (nats per score unit).
"""

import numpy as np

#: residue order of the chain (the standard 20-letter order)
VTML_RESIDUES = "ARNDCQEGHILKMFPSTWYV"

_LAM = float.fromhex("0x1.b538dfa66123ep-3")

_FREQ_HEX = (
    "0x1.03d2da3c27122p-4 0x1.65aa6736eff77p-5 0x1.0ae7ae54cc3a3p-5 "
    "0x1.5e971f572b588p-5 0x1.89a429088fdfbp-6 0x1.527b0eda863a8p-5 "
    "0x1.1bae678ba9b5ep-4 0x1.4285c0f52fc29p-4 0x1.d0f26c7c56b0ap-6 "
    "0x1.b05ba9986dbcfp-5 0x1.5045161859021p-4 0x1.db36af027ed3bp-5 "
    "0x1.e0895d7578261p-6 0x1.1f7a6677ae360p-5 0x1.56ff17aa2c11cp-5 "
    "0x1.324e5872bc679p-4 0x1.f610455ec1da8p-5 0x1.472a5dcd1f7d4p-6 "
    "0x1.0748c3f4988d1p-5 0x1.6a4e689f42fcbp-4 "
)

_PSI_HEX = (
    "0x1.205ddfdd15bbap-15 0x1.8e8f057d47d56p-23 0x1.5f24dc510ac9ep-16 "
    "0x1.1c650283b05fcp-14 0x1.1002b098130f3p-14 0x1.c4ea5efa902c7p-14 "
    "0x1.43df3ca604ea3p-13 0x1.eb566dc3f904ap-17 0x1.168e7fd2e795bp-18 "
    "0x1.66d2c42e3b782p-15 0x1.75706796b5f01p-15 0x1.e423bb316aa02p-16 "
    "0x1.051fe0973e262p-16 0x1.55878ce053dc5p-14 0x1.00e5b6aa05247p-11 "
    "0x1.4c712accd9001p-14 0x1.011cc25627351p-17 0x1.745653fbf553ap-17 "
    "0x1.285499083199bp-12 0x1.105755a855618p-16 0x0.0p+0 "
    "0x1.b8760bd71b57ap-18 0x1.1671f88aee318p-14 0x1.498eaef65044ep-15 "
    "0x1.085792f358a8cp-15 0x1.11b12734d499ep-15 0x1.92a6864090df8p-17 "
    "0x1.7669924a30658p-15 0x1.5bf5737b693c5p-12 0x1.48f22f85f6355p-16 "
    "0x1.1cb8aa6fede1ap-18 0x1.875009c18950cp-16 0x1.370e3ed43fadcp-14 "
    "0x1.e67b9c083602bp-15 0x1.02067080fe3a6p-17 0x1.13a1f8566e422p-16 "
    "0x1.3ccc0cafafa00p-16 0x1.12ec19cea3e33p-13 0x1.df646c90aa3b2p-18 "
    "0x1.37c8c23f1d8f4p-15 0x1.83b558fcc4066p-15 0x1.37337f6953b6fp-14 "
    "0x1.61241636af7cep-15 0x1.219e9699ce930p-16 0x1.886eff530a400p-18 "
    "0x1.a294c6935d094p-14 0x1.8640696d5b374p-17 0x1.9195b7e9b3c10p-19 "
    "0x1.04389512de098p-16 0x1.38c64667f372bp-13 0x1.0db24295b28ffp-14 "
    "0x1.ee75fa429becap-20 0x1.50176073b7a94p-16 0x1.1be70e8887f7ep-16 "
    "0x1.33004fc61f61ep-19 0x1.2f42722d144a5p-15 0x1.1459a45fd6afap-12 "
    "0x1.edd105b450478p-15 0x1.536a0a69004e2p-16 0x1.f274205a7c468p-17 "
    "0x1.b73a297b2c190p-18 0x1.0fc894418a2a9p-14 0x1.5a59a5773076fp-17 "
    "0x1.328f79565ba6ap-20 0x1.6df84b0708f16p-16 0x1.cf24eeb00996cp-14 "
    "0x1.881a071d619a5p-15 0x1.2947bde0fece9p-19 0x1.6861c2685a018p-18 "
    "0x1.122a294fe5478p-18 0x1.5af92a2b0cb63p-18 0x1.5e58d387455fbp-19 "
    "0x1.246bf9d440403p-17 0x1.179669739f2b2p-18 0x1.d559b3d5492f4p-17 "
    "0x1.074f566972578p-16 0x1.40677e34effeep-19 0x1.409cf058a143fp-17 "
    "0x1.6a53a6b812976p-17 0x1.d169aede0b384p-22 0x1.e25b4b8efe0d2p-15 "
    "0x1.c75d55f5d1cf6p-16 0x1.cd704c4a3e9d6p-22 0x1.01cfd995bc74cp-16 "
    "0x1.671fda299cff8p-15 0x1.a497194715ddep-13 0x1.872950b6caf7ap-16 "
    "0x1.3bcc3fb3d9c84p-14 0x1.01b498dc8cfacp-20 0x1.87e53141f9390p-15 "
    "0x1.5f415503ce8a4p-13 0x1.6c4bb17c5bca1p-16 0x1.29edd4cfdc980p-18 "
    "0x1.67cfd1fc37eaap-16 0x1.fd2ddb46e3278p-15 0x1.c8990b395b524p-15 "
    "0x1.7d08517de7ddap-19 0x1.ad444e8c565e4p-18 0x1.5d33a828b4703p-15 "
    "0x1.27af300a5ba3ap-14 0x1.115a9b8fe0bb6p-15 0x1.77b4fde376afep-16 "
    "0x1.28ef77e4cff48p-16 0x1.8998261d9f9eap-13 0x1.cbf1ec133eb1cp-18 "
    "0x1.183aecc4a4d16p-17 0x1.35cbacfeaaabbp-15 0x1.7a2dcdf7a8488p-14 "
    "0x1.8d228cfb80c62p-14 0x1.aaee33a7ad266p-19 0x1.3f182b4c660fcp-17 "
    "0x1.49050ba992218p-14 0x1.545cd43a7d7efp-16 0x1.1a42be0b5d356p-18 "
    "0x1.ba004c7b68f36p-16 0x1.1dc98db79a2bap-15 0x1.912d0087d2d15p-17 "
    "0x1.6a5dd3ffa4f56p-18 0x1.a3cd0ba7cef53p-16 0x1.82cd67e40f45bp-13 "
    "0x1.75152e571b858p-16 0x1.3ef1b285b6510p-17 0x1.de8ce9fdcc3ddp-18 "
    "0x1.55a011ea96e1fp-17 0x1.745ffcba73f2ap-18 0x1.048b7d1a03055p-16 "
    "0x1.5f12d5097ffa6p-15 0x1.2bc2353379408p-17 0x1.258067425b6d3p-16 "
    "0x1.6ca068d13ec7cp-17 0x1.e57bca134a420p-16 0x1.5f643ff04e1f4p-17 "
    "0x1.4d1fa562f7e89p-18 0x1.8ce08c33abbcep-15 0x1.f88a0acf4447ep-18 "
    "0x1.b183d2e587b82p-12 0x1.bc2b68b7f0d44p-16 0x1.3c3e4b1b8aa34p-14 "
    "0x1.9d8a131bcd9ccp-15 0x1.188a5668e9e96p-17 0x1.4c56e8f71230cp-16 "
    "0x1.bf984a9894d56p-15 0x1.017db44fb83e2p-17 0x1.fbc43507450b6p-18 "
    "0x1.97a4a9bd856b6p-11 0x1.cf8f12df34fbep-16 0x1.ae902b63048d0p-13 "
    "0x1.4fcd1bc4f21aap-13 0x1.5b361bf7c80bbp-15 0x1.39775e2f050acp-15 "
    "0x1.324eafa432444p-14 0x1.0c1b25f942a81p-16 0x1.5f88638da0af2p-16 "
    "0x1.a603d174dca0dp-13 0x1.20c8bd3874768p-15 0x1.876208226a554p-20 "
    "0x1.0b6ee4a0b3fe8p-15 0x1.6fc2b85363bd0p-14 0x1.42d49fc31c2f4p-14 "
    "0x1.efcab133f4696p-19 0x1.ab34ab6679f72p-17 0x1.7123f0ccdd360p-16 "
    "0x1.4b8788b35b1b4p-15 0x1.3fa77f514dd3cp-18 0x1.1a7d08ea02424p-16 "
    "0x1.7ee71eef80b1cp-15 0x1.eb1e250ecfa74p-19 0x1.6f465e25ddb84p-19 "
    "0x1.aae78a9b73cf4p-14 0x1.d3fe188fc1162p-18 0x1.862bcafdfd8cdp-16 "
    "0x1.5c8a3b7220948p-17 0x1.2a2ea351e02bap-16 0x1.57b4339fd4e84p-13 "
    "0x1.55985e9252ac0p-16 0x1.a1ddc4a7c0d46p-14 0x1.93d49ed4e64ddp-15 "
    "0x1.020ce7e94cbf3p-19 0x1.44b2a7eb16edep-19 0x1.2fa29174da442p-15 "
    "0x1.fc54f344530c2p-12 0x1.3b0f3e74c9909p-17 0x1.1644a62237041p-15 "
    "0x0.0p+0 0x1.de9f5840c09a1p-19 0x1.5c185bb3250a0p-17 "
    "0x1.0033dafe18f80p-12 0x1.f6272e851d8ccp-16 0x1.099f6ec3c3b63p-17 "
    "0x1.2996b3ffc08cep-15 "
)

VTML_FREQS = np.array([float.fromhex(t) for t in _FREQ_HEX.split()])


def _generator():
    """The fitted generator Q (column convention: Q[i][j] = rate j->i)."""
    vals = np.array([float.fromhex(t) for t in _PSI_HEX.split()])
    psi = np.zeros((20, 20))
    iu = np.triu_indices(20, k=1)
    psi[iu] = vals
    psi = psi + psi.T
    q = psi / VTML_FREQS[None, :]
    return q - np.diag(q.sum(axis=0))


def vtml_exact_scores(n):
    """Exact (unrounded) 20x20 VTML scores at distance ``n``."""
    f = VTML_FREQS
    q = _generator()
    s = np.sqrt(f)
    sym = (q / s[:, None]) * s[None, :]
    sym = (sym + sym.T) / 2.0
    w, v = np.linalg.eigh(sym)
    M = (s[:, None] * ((v * np.exp(float(n) * w)) @ v.T)) / s[None, :]
    r = M / f[:, None]
    r = np.sqrt(r * r.T)
    return np.log(r) / _LAM


def vtml_scores(n):
    """Integer VTML-``n`` scores over ARNDCQEGHILKMFPSTWYVBZX*.

    The 20x20 block at ``n == 80`` regenerates the bundled VTML80
    bit-exactly; see the module docstring for the provenance of other
    distances and of the B/Z/X/star conventions.
    """
    f = VTML_FREQS
    t = vtml_exact_scores(n)
    aa = VTML_RESIDUES
    wbz = np.zeros((2, 20))
    for k, members in enumerate(("ND", "QE")):
        idx = [aa.index(a) for a in members]
        wbz[k, idx] = f[idx] / f[idx].sum()
    rows_bz = wbz @ t
    pair_bz = wbz @ t @ wbz.T
    full = np.zeros((23, 23))
    full[:20, :20] = t
    full[20:22, :20] = rows_bz
    full[:20, 20:22] = rows_bz.T
    full[20:22, 20:22] = pair_bz
    xrow = f @ t
    full[22, :20] = xrow
    full[:20, 22] = xrow
    full[22, 20:22] = wbz @ xrow
    full[20:22, 22] = wbz @ xrow
    full[22, 22] = f @ t @ f
    s = np.floor(full + 0.5).astype(np.int64)
    out = np.zeros((24, 24), dtype=np.int64)
    out[:23, :23] = s
    star = s[:20, :20].min() - 2
    out[23, :] = star
    out[:, 23] = star
    out[23, 23] = 1
    return out.astype(np.float32)

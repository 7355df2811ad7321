"""Fitted Dayhoff PAM evolutionary chain (data module).

Port of ``pyopal_tpu/_pam_chain.py``, copied unchanged.

The 20-state reversible Markov chain underlying the NCBI PAM series,
recovered by constrained fitting: every integer score of the published
PAM30/PAM70/PAM120 (half-bit) and PAM250 (third-bit) tables pins the
chain's exact log-odds at that power into the score's half-unit
rounding interval, and the chain is the feasible point nearest the
printed Dayhoff (1978) PAM1 matrix (see experiments/fit_pam2.py for
the fit and the regeneration proof).  `pam_scores` regenerates
those four published tables bit-exactly, which is asserted by
tests/test_matrices.py; tables at other PAM distances come from the
same chain.

Stored form: the symmetric flux phi[i][j] = f_j * M1[i][j] (upper
triangle, hex floats for exact round-tripping), where M1[i][j] is the
probability that residue j mutates to residue i over one PAM, and f is
the Dayhoff amino-acid frequency vector (normalized).

The reference gets these tables from its external `scoring-matrices`
dependency (upstream PyOpal pyproject.toml:44-46); here they are
first-class.
"""

import numpy as np

#: residue order of the chain (the standard 20-letter order)
PAM_RESIDUES = "ARNDCQEGHILKMFPSTWYV"

#: Dayhoff (1978) normalized amino-acid frequencies
PAM_FREQS = np.array([
    0.087, 0.041, 0.040, 0.047, 0.033, 0.038, 0.050, 0.089, 0.034,
    0.037, 0.085, 0.081, 0.015, 0.040, 0.051, 0.070, 0.058, 0.010,
    0.030, 0.065,
])
PAM_FREQS = PAM_FREQS / PAM_FREQS.sum()

# upper triangle (row-major, diagonal included) of the symmetric flux
_PHI_HEX = (
    "0x1.5f5d71d7418acp-4 0x1.1ba1e065d2333p-17 0x1.225222131681ep-15 "
    "0x1.969a88ac5eea8p-15 0x1.509bc4dabc355p-17 0x1.d170cbcc66478p-16 "
    "0x1.71dcb16a12155p-14 0x1.7f594721b40bep-13 0x1.2d225a6627a4cp-17 "
    "0x1.65ebdd2615cd6p-16 0x1.da24553f193c3p-16 0x1.173da0d98e2e0p-16 "
    "0x1.25a2493f17a36p-17 0x1.df0ed09278860p-18 0x1.a41a55e40f8c4p-14 "
    "0x1.001528a42088ap-12 0x1.7f3ff7b9dcaf8p-13 0x1.12de25bc8c9d3p-30 "
    "0x1.c69c3b284a2a2p-18 0x1.b9c0ea411751ep-14 0x1.4ca222cf1b88ap-5 "
    "0x1.0d4f62b700754p-18 0x1.d654b6dce0529p-22 0x1.c926dc548a3d0p-19 "
    "0x1.3e9fa2ede706dp-15 0x1.12e02ddf56c45p-30 0x1.9fa5b9ff965e5p-19 "
    "0x1.1187f1c500456p-15 0x1.396ddb255f9abp-17 0x1.8655249e3eac4p-18 "
    "0x1.42b81a9871a08p-13 0x1.83aadb2373bacp-18 0x1.4cbc2bf5a2825p-19 "
    "0x1.6fcf2db135c68p-16 0x1.6673794c488c7p-15 0x1.e9e75952d5558p-18 "
    "0x1.0e5b10c5d9bb6p-17 0x1.a1993d6d26adbp-21 0x1.a6c8e024fd39cp-18 "
    "0x1.418caaa6a76f6p-5 0x1.5b1a38fa2825fp-13 0x1.12dbefe9b10fap-30 "
    "0x1.063807c156adcp-16 0x1.f5d1ab580ae08p-16 0x1.86d40961f6d7fp-15 "
    "0x1.2b4313bbac61cp-14 0x1.661121cf01550p-17 0x1.82f4d276d0ea4p-17 "
    "0x1.b7acb315c4228p-14 0x1.12e0529f2eb62p-30 0x1.34c83147dd292p-19 "
    "0x1.145ca2a886f0ep-17 0x1.1b5eb4f95fa76p-13 0x1.aa5fa312e1556p-15 "
    "0x1.bee131e59df20p-21 0x1.88948c51b60b6p-17 0x1.3d7e94ddb080ap-18 "
    "0x1.7b50768946421p-5 0x1.12ddec661f3fep-30 0x1.a2e678766a47bp-16 "
    "0x1.10c004e6a8b00p-12 0x1.992c286d317fep-15 0x1.da217059da97ap-17 "
    "0x1.fdd2b6724276dp-19 0x1.12df4f520b82cp-30 0x1.b18f7d14ce6a2p-16 "
    "0x1.12dfa91efe113p-30 0x1.11b67d6500979p-30 0x1.071d1be9ce7a3p-18 "
    "0x1.0b565fcdcee1fp-15 0x1.1c16d0982425dp-16 0x1.787fcdf9b313ap-28 "
    "0x1.12d3f2eeb9bb0p-30 0x1.600cba5fc4113p-18 0x1.0d5819715ef5ap-5 "
    "0x1.12df6b303b1e1p-30 0x1.12de6e0f2aceap-30 0x1.82270882d5368p-19 "
    "0x1.a9b49256e8fbcp-19 0x1.437e83d4cbfd4p-18 0x1.12e0c1c4926cap-30 "
    "0x1.12dfa83b72dc8p-30 0x1.12e07df509f18p-30 0x1.dad56ef49c82ep-30 "
    "0x1.e500632c04774p-19 0x1.33736ed934a2cp-15 0x1.e4ff27f9d3a66p-19 "
    "0x1.12e0cb3cde656p-30 0x1.35f11b3addb20p-17 0x1.664bdeae1ea2ap-17 "
    "0x1.33486a18c5f22p-5 0x1.e514598ecb81fp-14 0x1.63b698f277351p-17 "
    "0x1.4c5547517211ep-14 0x1.7eab7c446355bp-19 0x1.6ebedbc740040p-16 "
    "0x1.8065eeef4ec40p-15 0x1.bb873e0e7e38dp-18 0x1.12dd3d2f7ffbbp-30 "
    "0x1.dd08b0e054ca6p-16 0x1.e1c926e85ca09p-17 0x1.81cbb126cecdcp-17 "
    "0x1.12da5f7374ec4p-30 0x1.12ddd387f1ab4p-30 0x1.23103bbd2653fp-17 "
    "0x1.93d6968ada311p-5 0x1.274b354315b88p-15 0x1.a051af9faae6ap-18 "
    "0x1.77210b59e11bap-17 0x1.9fad97c831d2ep-18 0x1.123395b1630e2p-15 "
    "0x1.359e721f88942p-19 0x1.12cbbd6ed5fafp-30 0x1.aec8aae424ba2p-17 "
    "0x1.c921109db38a2p-16 0x1.626fab026d178p-17 0x1.12594f5f41b45p-30 "
    "0x1.d9d015b5286d8p-19 0x1.8464ac218bfe7p-17 0x1.69d460bcd336ep-4 "
    "0x1.26ab74f278ad8p-19 0x1.12e09fe22d718p-30 0x1.134f610593f04p-17 "
    "0x1.1a2f2d5ec4953p-16 0x1.108edb3a3e7f3p-19 0x1.5985dcdeeb370p-18 "
    "0x1.201bc0efa4ce6p-16 0x1.2cb9d231fe976p-13 0x1.2536bc94b6f0ep-16 "
    "0x1.12dfa134a1d02p-30 0x1.12d982d154d7cp-30 0x1.075deb173df70p-15 "
    "0x1.13cf3ec6c3bb2p-5 0x1.2df7685aa8b9ap-21 0x1.67ffd5b8a6c01p-17 "
    "0x1.e91e9455aa3ffp-18 0x1.12e0a6bc0f319p-30 0x1.ac74c9b023bedp-18 "
    "0x1.2a51522090da0p-16 0x1.d079a38c05238p-18 0x1.4f9cabf894270p-18 "
    "0x1.e870ec50664fcp-21 0x1.a842c4d541b46p-17 0x1.8b7d3c2e8a282p-17 "
    "0x1.2b037dbe8ce47p-5 0x1.505b2fc2a2d06p-14 0x1.ec7033a082e92p-17 "
    "0x1.2ef357fbdfd04p-16 0x1.e4798222c35a2p-16 0x1.2e7185c0cabedp-19 "
    "0x1.dee46e10f930fp-18 0x1.4375495bff04ap-15 0x1.21c608f52ae8ep-29 "
    "0x1.21b3d5b61182ap-18 0x1.ab3a822e95317p-13 0x1.59f3744d5eea8p-4 "
    "0x1.88ad5632c5f6cp-17 0x1.1cf1149a504b2p-14 0x1.c0e101051ff8fp-15 "
    "0x1.efd24cd56d62cp-17 0x1.23eb5241a5300p-17 0x1.15db478054619p-16 "
    "0x1.dd2beb6473a0dp-19 0x1.dde7ea25447e0p-18 0x1.99f0819d948c4p-14 "
    "0x1.48fb1f6388cd6p-4 0x1.edaa35255c2e9p-16 0x1.12dee930b82a2p-30 "
    "0x1.05d4398512543p-16 0x1.c0e947c4428eep-15 0x1.07dbe5b805486p-14 "
    "0x1.12e5d4dc900eap-30 0x1.9f7e9ce10be9cp-19 0x1.c2e52010ca750p-18 "
    "0x1.e4d7ee42c304ep-7 0x1.47a02f390ff02p-18 0x1.dab5531e676b7p-21 "
    "0x1.acca435976075p-18 0x1.51235f9015f26p-17 0x1.1ae95d3292256p-30 "
    "0x1.861197026c274p-30 0x1.ae95e7ce320f0p-16 0x1.4587314ac25efp-5 "
    "0x1.e811563b0c00cp-20 0x1.a4d3ec0b1d798p-17 0x1.b80e2329e82bep-19 "
    "0x1.ae0109c93d53fp-19 0x1.7729de0987008p-14 0x1.caaf979cf845dp-20 "
    "0x1.9e48b35e28980p-5 0x1.6c8954aedbfdbp-14 0x1.a3afa4493c14cp-16 "
    "0x1.12bd7c7f8704cp-30 0x1.1313c6a9b3fd0p-30 0x1.0b388316dbbdfp-16 "
    "0x1.19eaff56101c5p-4 0x1.ca0600b4a0e43p-13 0x1.62cb0d8adfd06p-18 "
    "0x1.ae9428e0946c0p-18 0x1.eadb319bd42afp-17 0x1.d4935ef76bb41p-5 "
    "0x1.12e01d747cdb2p-30 0x1.c85c7b740ec58p-18 0x1.d042890c7cfe6p-15 "
    "0x1.46936a714edf6p-7 0x1.e42db1e72aff0p-20 0x1.5d3ab560d1b0dp-25 "
    "0x1.e83c505c64462p-6 0x1.ca0a2be9a9faap-18 0x1.076b03c1e8b28p-4 "
)


def pam1_matrix():
    """The fitted PAM1 column-stochastic mutation matrix (20x20)."""
    vals = np.array(
        [float.fromhex(t) for t in _PHI_HEX.split()]
    )
    phi = np.zeros((20, 20))
    iu = np.triu_indices(20)
    phi[iu] = vals
    phi = phi + np.triu(phi, 1).T
    m = phi / PAM_FREQS[None, :]
    # the stored diagonal is phi_ii = f_i * M_ii; columns sum to 1 by
    # construction of the fit -- renormalize defensively anyway
    m = m / m.sum(axis=0, keepdims=True)
    return m


def pam_scores(n, lam):
    """Integer PAM-``n`` scores over ARNDCQEGHILKMFPSTWYVBZX* at scale
    ``lam`` (nats per score unit), following the published NCBI
    conventions (regenerates the PAM30/70/120/250 files bit-exactly;
    see tests/test_matrices.py)."""
    m1 = pam1_matrix()
    f = PAM_FREQS
    mn = np.linalg.matrix_power(m1, n)
    r = mn / f[:, None]
    r = np.sqrt(r * r.T)  # symmetric odds ratios
    t = np.log(r) / lam  # exact 20x20 scores
    aa = PAM_RESIDUES
    # B/Z: frequency-weighted mixtures in odds space
    wbz = np.zeros((2, 20))
    for k, members in enumerate(("ND", "QE")):
        idx = [aa.index(a) for a in members]
        wbz[k, idx] = f[idx] / f[idx].sum()
    rows_bz = np.log(wbz @ r) / lam  # (2, 20)
    pair_bz = np.log(wbz @ r @ wbz.T) / lam  # (2, 2)
    full = np.zeros((23, 23))
    full[:20, :20] = t
    full[20:22, :20] = rows_bz
    full[:20, 20:22] = rows_bz.T
    full[20:22, 20:22] = pair_bz
    # X: frequency-weighted average of exact scores; X-vs-B/Z applies
    # the B/Z mixture to the X column
    xrow = f @ t
    full[22, :20] = xrow
    full[:20, 22] = xrow
    full[22, 20:22] = wbz @ xrow
    full[20:22, 22] = wbz @ xrow
    full[22, 22] = f @ t @ f
    s = np.floor(full + 0.5).astype(np.int64)
    out = np.zeros((24, 24), dtype=np.int64)
    out[:23, :23] = s
    star = s.min()
    out[23, :] = star
    out[:, 23] = star
    out[23, 23] = 1
    return out.astype(np.float32)

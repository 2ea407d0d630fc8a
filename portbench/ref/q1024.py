"""Frozen copy of ``echoseal_torch/data/q1024.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

3GPP TS 38.212 polar reliability sequence for N=1024.

The sequence is the standard 5G NR polar-code reliability ordering restricted
to N=1024, stored most-reliable-first: the first K entries form the
information set (frozen mask = everything else).  This is the same public
standards constant the reference vendors as ``Q_Nmax`` in
``rtwm/reliability_polar_bits.py`` (see rtwm/fastpolar.py:10-16, 220-227 for
the convention).  Stored zlib+base85-packed (uint16 little-endian) to keep the
source compact.
"""
from __future__ import annotations

import base64
import zlib

import numpy as np

_PACKED = (
    "c-jTQ17HvU00h8Cwr$(is%6`@ZM&9j+qP}nwr$-3gb)m&5DAH31V=%HMhHYk7(~GUghOH!LNtI$5DUo=5(7~fP*|"
    "iw5e!09ghwVsKnal1F$75=#sO6U$q^edFap6CiYXv9Kp;|MJmR4!(jb^JqZA@>K0+xGBWXVpsTk5>Fe)MoN+Kc(a"
    "wxJPCWc`E%OD7qkPC6q5Gi3+!AML%aK=YkG=fzFqmcj;Q5+!{nhQ`+>CprOlogYa0i_X!kr`Yqun^gC0Mk(xivfp"
    "Y6oya^R7P%uRtF46IV9#mR7Es~Q64PEC^SYj<U=ghL=r|;I330qG{q#W$5=#BAtuCe)Iwq<V_`;9NKQdBv_vMR;v"
    "&>RMug=+CQ%Wd#~@C{3@kw_<U|R^QXwT%N6bWdgl8KR)_p8RNTt#tMBqS$Ra6#HQs%`9WKt(Y=WJBR5p=;y<VRG6"
    "*C54a3`WofB<B#;MhVeJu^K&a0u@*QaX1dmu@Na)7ejOs6%@!3Oij5pHe(ttARb4k9!?_-$FqSNuqdNz7A_()lPV"
    "qCVmo3ewmM@O9-tVrFqr3Hyh^eiy5cfcA(Tt;A(AVO1~VJ4V?HA?Cg-9eQ)s@rp$r2RPeZu|J&{_+5XqbH7?qfd`"
    "!$Sfkw!%o#JKE*{cOn0I)wmK;YdbQF{RTMq-1<PM<1NQRt#1aC16RVWg}j~1n$6S)?g_ORYk?rdz?jm6lXRi@<cX"
    "aR;K3yUO_GubQ$f$Fiqwo3~(haWCjMwZo#-}kJ7w~?A(n5yn*R#s47aSk$Qr8Sj-%Zui$Q^2`bC(sG-Wdi4GjCrx"
    "?!MJjetp#}`Pe5MGDgn5ZVI%Fw=zJY3FET%h7=%!J&Am*|W1nyeP8#(eyMFwUx)Jj^ki#B*4v42taaY|34Djp^#3"
    "(hBDT>W7cWuCc7e<7~z$%*fpOjLO=B99pcFJgBm|hA1AcI$Xr5JkRAy>{cwN8O)<-uBv>xg`7OBYO1MGTEbXP;>N"
    "0_nS6%z8l&&%$h~O8v6`gvywAM6gHCL!rCh;7Y^H>Ih1smmE)41Xyo;4Q!Z*mMLQdx6D(opr<*;t4I@-YV%H$%h&"
    "4K=esXEF6T%=YS<nZpn)tsUG%Bd3WsJCd&6CB5=F0ZB9$R(=FFF47WYNOWdk9~;XY23_C%Bu@pp|3ckdaSP5is94"
    "zftAXySxoBaKBBhV&Mw-ZZd}HTjP0N3%m*x>IjpUAyv%VL;^c0w)jFy*jN{+v%DSrHjXI$oddL)B#Sxy%dzhxp3U"
    "q5-=P|}}YM;~v74>N~a2nUscwf|Z_2edIb^zNdogZ^8i+Prw^BsEe6x*q@wy+Pg_zd53j+W`NO1i7+^Afl6fqvmE"
    "cX9`>@EcaClpkua=PIHrI-9R+zGJ#Qhq{~AsEm8+nEqgsa(S57>ai-hJ9qOcA8{U^FvxLzgT3@zRlMH~y+!do(x;"
    "TtH`zy9^%rLppb1XkwC>FvTF3f&!A8EMryT9GO7GjO;o`ocoto(PYT~TU;B8#smu#<jdZfud$I|Z04_xT%zN!Om;"
    "n(c08``a1e4?_R?taYS%D$<O?BJ)`!)xrV#a^f3&h5`E=NHQ3+uF;6UhZ40>c;M?QGUj4dZ~Q=plYt^?@Z`_IP5V"
    "#r#qbFetNC-Zt7RurH`uRyFBjx9P5le?`EFjYkI?$-lIkStUCV0TgvH~Zsn=|$|ZiL@9OBc+^ZS>!Zt4N``*Vp%I"
    "l@><P|>TSNg%~p6$EJ?;~F6F8;|k+Tf%9q}pEX0v_k)?ynxc$Bllg6aLM*{-Tqf=GLy~uiESjp5@d2p|;-ccig9C"
    "zUa>Wsc)R)cD|<v?&?*3=*yn#-&*5i?&bh*@-O!Eb-&YEKlUm2@*i&T89#R)Z*_ft(|iBrCGYSro%K$)_Z46DJU{"
    "Xu?RIzH@DtzkI`{Td|J6U<_6u+GOZW9T_wxtu@@s$e9$)ib-|}Za^LPK#9l!EjzwthQ@)!5_TYvQr|MWfo_B(&`F"
    "aPmh|MPz}^aLL"
)


def reliability_sequence(n: int = 1024) -> np.ndarray:
    """Return the reliability permutation of 0..n-1, most reliable first."""
    rel = np.frombuffer(
        zlib.decompress(base64.b85decode(_PACKED)), dtype="<u2"
    ).astype(np.int64)
    if n == rel.size:
        return rel.copy()
    if n > rel.size:
        raise ValueError(f"reliability table only covers N<={rel.size}, got {n}")
    # Standard nested property: the length-n sequence is the subsequence of
    # entries < n (3GPP 38.212 sec 5.3.1.2).
    return rel[rel < n].copy()

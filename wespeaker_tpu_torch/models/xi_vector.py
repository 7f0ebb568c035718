"""Xi-vector: the ECAPA-TDNN and x-vector bodies with the Gaussian
posterior-inference pooling (XI, models/pooling_layers.py).

Counterpart of wespeaker_tpu/models/xi_vector.py. The ECAPA body keeps
its eval kernels for the three SE-Res2 blocks; the MFA + ASTP tail kernel
does not apply, since the tail fuses for ASTP only.
"""

from wespeaker_tpu_torch.models import ecapa_tdnn, tdnn


def XI_VEC_ECAPA_TDNN_c1024(feat_dim, embed_dim, pooling_func="XI",
                            emb_bn=False, **kwargs):
    return ecapa_tdnn.ECAPA_TDNN(channels=1024, feat_dim=feat_dim,
                                 embed_dim=embed_dim,
                                 pooling_func=pooling_func, emb_bn=emb_bn,
                                 **kwargs)


def XI_VEC_ECAPA_TDNN_c512(feat_dim, embed_dim, pooling_func="XI",
                           emb_bn=False, **kwargs):
    return ecapa_tdnn.ECAPA_TDNN(channels=512, feat_dim=feat_dim,
                                 embed_dim=embed_dim,
                                 pooling_func=pooling_func, emb_bn=emb_bn,
                                 **kwargs)


def XI_VEC_XVEC(feat_dim, embed_dim, pooling_func="XI"):
    return tdnn.XVEC(feat_dim=feat_dim, embed_dim=embed_dim,
                     pooling_func=pooling_func)

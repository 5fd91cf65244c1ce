"""Compatibility shim, as ``repro/core/accountant.py``: DP accounting lives
in :mod:`repro_torch.core.privacy` (the closed-form math in
``privacy/bounds.py``, the per-silo :class:`PrivacyLedger` and the legacy
scalar :class:`PrivacyAccountant` in ``privacy/ledger.py``)."""
from repro_torch.core.privacy.bounds import (DEFAULT_ORDERS, _log_comb, _phi,
                                             calibrate_sigma, composed_delta,
                                             composed_eps, corrected_delta,
                                             gaussian_delta, gaussian_eps,
                                             rdp_gaussian,
                                             rdp_subsampled_gaussian,
                                             rdp_to_eps, sequence_eps,
                                             sequence_sensitivity)
from repro_torch.core.privacy.ledger import PrivacyAccountant, PrivacyLedger

__all__ = [
    "DEFAULT_ORDERS", "calibrate_sigma", "composed_delta", "composed_eps",
    "corrected_delta", "gaussian_delta", "gaussian_eps", "rdp_gaussian",
    "rdp_subsampled_gaussian", "rdp_to_eps", "sequence_eps",
    "sequence_sensitivity", "PrivacyAccountant", "PrivacyLedger",
]

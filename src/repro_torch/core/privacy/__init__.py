"""Privacy accounting (paper section 4.1, Appendix A): the port's copy of
``repro/core/privacy``, the closed-form bounds (:mod:`.bounds`) and the
per-silo :class:`PrivacyLedger` with its budgets, RDP mode and state dicts,
plus the legacy scalar :class:`PrivacyAccountant` (:mod:`.ledger`)."""
from repro_torch.core.privacy.bounds import (DEFAULT_ORDERS, calibrate_sigma,
                                             composed_delta, composed_eps,
                                             corrected_delta, gaussian_delta,
                                             gaussian_eps, rdp_gaussian,
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

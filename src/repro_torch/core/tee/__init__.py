"""The TEE protocol tier (paper sections 3.2-3.3, 5-6): attestation, the
key distribution service, the sandbox, sealed channels, the Merkle batch
tag, the packed wire codec and the attested components. Port of
``repro/core/tee``: numpy and hashlib on the host, the handlers' gradients
and ``clip_mask`` on the session's device."""

"""Host-side helpers (copies of ``primus_fhe_tpu/utils``): modular inverses,
NTT primes, bit reversal, range contracts, serialization, secrets,
profiling and the security estimator."""

"""Host-side integer helpers (copies of what the port uses of
``primus_fhe_tpu/utils``): modular inverses, NTT primes, bit reversal."""

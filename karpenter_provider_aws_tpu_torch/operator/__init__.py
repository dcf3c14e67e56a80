"""The ambient single-replica ownership scope the controllers consult
(``sharding``). The operator runtime, options and the N-replica elector are
not carried yet."""

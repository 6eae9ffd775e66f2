"""Host codec of the port: binarization, the CABAC range coder and its
lane engines, the DCBC container, the rate model and the host quantizers
(copies of ``repro.core``, held byte- and bit-exact to it in the tests)."""

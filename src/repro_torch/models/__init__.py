"""Models of the port: the dense decoder-only LM (:mod:`.transformer`) on
the shared layers (:mod:`.layers`)."""

"""The stateful session tier's sequence framing (``framing.py``, host
numpy, copied from the JAX package): one candidate buffer carries a
sequence of messages, the ``manager`` mutator's ``{"framed": 1}``
format.  The session scan and state x edge coverage are not ported
yet."""

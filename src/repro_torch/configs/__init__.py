"""Architecture configurations of the LM substrate: ``base`` (the
dataclasses, ``SHAPES``) and one module per architecture id, each holding
its ``CONFIG``, equal to the JAX package's."""

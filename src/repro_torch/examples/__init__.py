"""The port's examples: each walks the flow of its counterpart under the
repository's ``examples/`` through ``repro_torch``, on the card unless it
is given ``--device cpu``."""

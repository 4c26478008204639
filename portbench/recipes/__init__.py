"""Pattern recipes: one module a recipe, found by the name a
configuration gives in ``patterns.recipe``.

A recipe module defines ``make(seed, **params)``, the patterns (``str``
or ``bytes``) from the seed and the configuration's other ``patterns``
keys; a key it does not take is refused by Python itself.
"""

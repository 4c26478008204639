"""Texts: one module a text, found by the name a traffic mix gives in
its ``text`` key.

A text module defines

* ``KEYS``: the mix parameters of its own that it reads;
* ``document(patterns, params, size, index, seed)``: distinct document
  ``index`` of ``size`` characters (a ``str``) or bytes (``bytes``);
* ``lines(patterns, params, first, count, seed)``: lines ``first`` ..
  ``first + count - 1`` of a batch corpus;

and may leave out the one of the two its text has no use for.  A text
reads the configuration's patterns only to place them.
"""

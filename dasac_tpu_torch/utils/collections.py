"""Attribute-access dictionary with recursive immutability (a copy of
``dasac_tpu/utils/collections.py``; the reference's ``utils/collections.py``
AttrDict).
"""


class AttrDict(dict):
    """A dict whose items are also reachable as attributes.

    Supports freezing: once ``immutable(True)`` is called, any mutation of this
    dict (or any nested AttrDict) raises ``AttributeError``.
    """

    _IMMUTABLE_KEY = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict._IMMUTABLE_KEY] = False

    def __getattr__(self, name):
        if name in self.__dict__:
            return self.__dict__[name]
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self.__set(name, value, as_attr=True)

    def __setitem__(self, name, value):
        self.__set(name, value, as_attr=False)

    def __set(self, name, value, as_attr):
        if self.__dict__[AttrDict._IMMUTABLE_KEY]:
            raise AttributeError(
                "AttrDict is immutable; cannot set {!r}".format(name)
            )
        if as_attr and name in self.__dict__:
            self.__dict__[name] = value
        else:
            super().__setitem__(name, value)

    def is_immutable(self):
        return self.__dict__[AttrDict._IMMUTABLE_KEY]

    def immutable(self, flag=True):
        """Recursively (un)freeze this dict and every nested AttrDict."""
        self.__dict__[AttrDict._IMMUTABLE_KEY] = flag
        for v in self.__dict__.values():
            if isinstance(v, AttrDict):
                v.immutable(flag)
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(flag)

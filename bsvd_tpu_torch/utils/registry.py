"""Name -> implementation registry of the port (counterpart of
bsvd_tpu/utils/registry.py; the port registers archs, losses and models).
Options dicts select an implementation with a ``type:`` key.
"""


class Registry:
    """A name -> object mapping supporting decorator-style registration.

    Example::

        ARCH_REGISTRY = Registry('arch')

        @ARCH_REGISTRY.register()
        class BSVD: ...

        cls = ARCH_REGISTRY.get('BSVD')
    """

    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def _do_register(self, name, obj):
        if name in self._obj_map:
            raise KeyError(f"An object named '{name}' was already registered "
                           f"in '{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj=None):
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class
            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name):
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"No object named '{name}' found in '{self._name}' "
                           f"registry! Available: {sorted(self._obj_map)}")
        return ret


ARCH_REGISTRY = Registry('arch')
LOSS_REGISTRY = Registry('loss')
MODEL_REGISTRY = Registry('model')

from .apiserver import APIServer, WatchEvent  # noqa: F401
from .informers import SharedInformerFactory  # noqa: F401
from .resources import Descriptor, PatchNodeParam  # noqa: F401

"""Observability UI: StatsListener → StatsStorage → web dashboard.

Parity: reference ``deeplearning4j-ui-parent`` — ``StatsListener.java:47``
(score/timing/memory/param-histogram collection), Play-framework ``UIServer``
with train-overview module. Here: stdlib ``http.server`` dashboard (no Play,
no SBE codecs — JSON over HTTP).
"""

from .server import UIServer
from .stats import StatsListener
from .listeners import ConvolutionalIterationListener
from . import components

__all__ = ["StatsListener", "UIServer", "ConvolutionalIterationListener",
           "components"]

"""repro_torch.manager — the autonomous cluster-manager control plane (§4.4).

Monitor availability feeds, replan incrementally on every change, price
each transition, and reconfigure the elastic trainer kill-free (or roll
back, or defer).  See DESIGN.md §11.

A copy of ``repro/manager/__init__.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from repro_torch.manager.autoscale import (AutoscaleConfig, AutoscaleDecision,
                                     ServingController, plan_fits_capacity)
from repro_torch.manager.controller import (Controller, ControllerConfig,
                                      fit_runtime_plan)
from repro_torch.manager.events import (CapacityDown, CapacityUp, ClusterEvent,
                                  EventBus, LinkDegraded, NodeFailure,
                                  PriceChange, Straggler)
from repro_torch.manager.monitor import AvailabilityMonitor, ListFeed, TraceFeed
from repro_torch.manager.replan import IncrementalReplanner
from repro_torch.manager.transition import (DEFER, RESHARD, ROLLBACK, ROUTE_AROUND,
                                      TransitionConfig, TransitionDecision,
                                      TransitionModel)

__all__ = [
    "AutoscaleConfig", "AutoscaleDecision", "AvailabilityMonitor",
    "CapacityDown", "CapacityUp", "ClusterEvent",
    "Controller", "ControllerConfig", "DEFER", "EventBus",
    "IncrementalReplanner", "LinkDegraded", "ListFeed", "NodeFailure",
    "PriceChange", "RESHARD", "ROLLBACK", "ROUTE_AROUND",
    "ServingController", "Straggler",
    "TraceFeed", "TransitionConfig", "TransitionDecision", "TransitionModel",
    "fit_runtime_plan", "plan_fits_capacity",
]

"""Generate reference-grade markdown documentation for the env catalog
(counterpart of apx.tools.mk_env_doc).

Behavioral counterpart of the reference's tools/mk_env_doc.py (785 lines):
emits the same page set and section structure as the reference's doc/
directory — family base pages (Properties, per-space sections, Rewards,
Starting State, Episode End, Arguments, Overview) factored from per-ID
diff pages (header table, Description, Example Usage, Version History,
Variants) — and goes beyond it: the reference documents only 16 of its
ids (no Inverted/Double/t32/t64/HideAndSeek/CIFAR10-cN/-train/-test/
-sparse pages); here every variant appears in a Variants table and every
page documents the `-sparse-v0` twin's reward composition.

Space strings are INTROSPECTED from the port's built compat envs
(gymnasium reprs, identical to the reference's and apx's), not
hand-written; counts/sizes come from the registry and the real dataset
geometry tables. The pages are apx's, byte for byte, but for the lines
that name the package. It needs gymnasium; the envs are built on
``--device`` (the card by default).

Usage: python -m apx_torch.tools.mk_env_doc [--out docs/envs] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

HEADER_NOTE = (
    "<!-- Generated by apx_torch.tools.mk_env_doc — do not edit by hand. -->\n"
)

_OUT_DIR = {"path": "docs/envs"}  # set by generate(); _gif checks it
_DEVICE = {"device": "cuda"}  # set by generate(); the envs are built there


def _gif(env_id: str) -> str:
    """Reference-style centered GIF header when the image exists
    (generate with apx_torch.tools.create_env_vid into <out>/img/)."""
    rel = f"img/{env_id}.gif"
    if os.path.exists(os.path.join(_OUT_DIR["path"], rel)):
        return (
            f'<p align="center"><img src="{rel}" alt="{env_id}" '
            'width="200px"/></p>\n\n'
        )
    return ""

SPARSE_NOTE = (
    "\nEvery environment also registers a `-sparse-v0` twin (e.g. "
    "`{sparse_id}`) in which the loss term is applied only on the final "
    "(terminating) step of the episode: the prediction target becomes "
    '`{{"target", "weight"}}` with `weight = terminated`, and the reward is '
    "recomputed as `base_reward - weight * loss` "
    "(reference sparsify_wrapper.py:23-164).\n"
)


# ---------------------------------------------------------------------------
# Introspection helpers


def _gym_spaces(env_id: str):
    import apx_torch.compat as apc

    env = apc.make(env_id, log_wrapper=False, device=_DEVICE["device"])
    return {
        "action": repr(env.inner_action_space),
        "prediction": repr(env.prediction_space),
        "prediction_target": repr(env.prediction_target_space),
        "observation": env.observation_space,
    }


def _obs_html(space) -> str:
    import gymnasium as gym

    if isinstance(space, gym.spaces.Dict):
        rows = "".join(
            f"<br/><code>&nbsp;&nbsp;{k!r}: {space.spaces[k]!r}</code>"
            for k in space.spaces
        )
        return f"<code>Dict({{</code>{rows}<br/><code>}})</code>"
    return f"<code>{space!r}</code>"


def _properties_table(sp, loss_name: str) -> str:
    return f"""## Properties

<table>
  <tr>
    <td><strong>Action Space</strong></td>
    <td><code>{sp['action']}</code></td>
  </tr>
  <tr>
    <td><strong>Prediction Space</strong></td>
    <td><code>{sp['prediction']}</code></td>
  </tr>
  <tr>
    <td><strong>Prediction Target Space</strong></td>
    <td><code>{sp['prediction_target']}</code></td>
  </tr>
  <tr>
    <td><strong>Observation Space</strong></td>
    <td>{_obs_html(sp['observation'])}</td>
  </tr>
  <tr>
    <td><strong>Loss Function</strong></td>
    <td><code>{loss_name}</code></td>
  </tr>
</table>
"""


def _kv_table(rows: list[tuple[str, str]]) -> str:
    out = ["|                     |                     |", "|---|---|"]
    for k, v in rows:
        out.append(f"| **{k}** | {v} |")
    return "\n".join(out) + "\n"


def _example_usage(env_id: str) -> str:
    return f"""## Example Usage

```python
import apx_torch.compat.ap_gym_alias  # or: import ap_gym (reference scripts)
import ap_gym

env = ap_gym.make("{env_id}")

# Or for the vectorized version with 4 environments:
envs = ap_gym.make_vec("{env_id}", num_envs=4)
```

## Version History

- `v0`: Initial version
"""


def _variants_table(rows: list[tuple[str, str]]) -> str:
    if not rows:
        return ""
    out = [
        "## Variants",
        "",
        "| Environment ID | Description |",
        "|---|---|",
    ]
    for vid, desc in rows:
        out.append(f"| {vid} | {desc} |")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Curated catalog metadata (descriptions mirror the reference's idoc texts;
# dataset sizes are the real corpora sizes, registration.py:410-690 and
# HF_DATASET_GEOMETRY)

IMG_CLS_FAMILIES = {
    "CircleSquare": dict(
        image_type="Grayscale", n_points=1568, img="28x28", glimpse="5x5",
        steps=16, classes=2,
        img_desc="An image containing either a circle or square.",
        desc=(
            "In the CircleSquare environment, the agent's objective is to "
            "determine whether a given image contains a circle or a square. "
            "The agent has limited visibility, represented by a small movable "
            "glimpse that captures partial views of the image. A visual "
            "gradient within the image guides the agent towards the object."
        ),
        variants=[
            ("CircleSquare-s28-v0", "Alias for CircleSquare-v0."),
            ("CircleSquare-s20-v0", "Smaller image size of 20 instead of 28."),
            ("CircleSquare-s15-v0", "Even smaller image size of 15."),
            ("CircleSquare-nograd-v0", "No gradient as visual aid."),
            ("CircleSquare-s20-nograd-v0", "20px images, no gradient."),
            ("CircleSquare-s15-nograd-v0", "15px images, no gradient."),
            ("CircleSquare-t32-v0", "Step limit 32 instead of 16."),
            ("CircleSquare-t64-v0", "Step limit 64 instead of 16."),
            ("CircleSquareInverted-v0",
             "Labels are randomly inverted per episode; the inversion bit is "
             "observable only on the first step (then reads 2)."),
            ("CircleSquareInverted-s15-v0", "Inverted labels, 15px images."),
            ("CircleSquareInverted-nograd-v0", "Inverted labels, no gradient."),
            ("CircleSquareInverted-s15-nograd-v0",
             "Inverted labels, 15px, no gradient."),
            ("DoubleCircleSquare-v0",
             "Two objects, 3 classes (two circles / two squares / mixed)."),
            ("DoubleCircleSquare-s15-v0", "Double variant, 15px images."),
            ("DoubleCircleSquare-s20-v0", "Double variant, 20px images."),
            ("DoubleCircleSquare-nograd-v0", "Double variant, no gradient."),
            ("DoubleCircleSquare-s15-nograd-v0", "Double, 15px, no gradient."),
            ("DoubleCircleSquare-s20-nograd-v0", "Double, 20px, no gradient."),
            ("CircleSquareHideAndSeek-v0",
             "Adds a seek/flee base reward: sign(label) * distance between "
             "glimpse and object (seek squares, flee circles)."),
            ("CircleSquareHideAndSeekNoPrediction-v0",
             "Hide-and-seek with the prediction channel masked out "
             "(ZeroLossFn, empty prediction spaces)."),
        ],
    ),
    "MNIST": dict(
        image_type="Grayscale", n_points=60000, img="28x28", glimpse="5x5",
        steps=16, classes=10,
        img_desc="Handwritten digits from the "
        "[MNIST dataset](http://yann.lecun.com/exdb/mnist/).",
        desc=(
            "In the MNIST environment, the agent's objective is to classify "
            "images of handwritten digits (0-9). The agent has limited "
            "visibility, represented by a small movable glimpse that captures "
            "partial views of the image. It must strategically explore "
            "different regions of the image to gather enough information for "
            "accurate classification."
        ),
        variants=[
            ("MNIST-train-v0", "Uses the train split of MNIST (same as MNIST-v0)."),
            ("MNIST-test-v0", "Uses the test split of MNIST."),
        ],
    ),
    "CIFAR10": dict(
        image_type="RGB", n_points=50000, img="32x32", glimpse="5x5",
        steps=16, classes=10,
        img_desc="Natural images from the "
        "[CIFAR10 dataset](https://www.cs.toronto.edu/~kriz/cifar.html).",
        desc=(
            "In the CIFAR10 environment, the agent's objective is to classify "
            "natural images into one of ten categories. The agent has limited "
            "visibility, represented by a small movable glimpse."
        ),
        variants=[
            ("CIFAR10-train-v0", "Uses the train split (same as CIFAR10-v0)."),
            ("CIFAR10-test-v0", "Uses the test split."),
        ] + [
            (f"CIFAR10-c{k}-v0",
             f"Restricted to the first {k} classes (labels remapped 0..{k - 1}); "
             f"also registers -train/-test splits.")
            for k in range(2, 11)
        ],
    ),
    "TinyImageNet": dict(
        image_type="RGB", n_points=100000, img="64x64", glimpse="10x10",
        steps=16, classes=200,
        img_desc="Natural images from the [Tiny ImageNet dataset]"
        "(https://huggingface.co/datasets/zh-plus/tiny-imagenet).",
        desc=(
            "In the TinyImageNet environment, the agent's objective is to "
            "classify 64x64 natural images into one of 200 categories with a "
            "10x10 glimpse."
        ),
        variants=[
            ("TinyImageNet-train-v0", "Uses the train split."),
            ("TinyImageNet-test-v0", "Uses the validation split."),
        ],
    ),
}

IMG_LOC_FAMILIES = {
    "MNISTLoc": dict(
        base="MNIST", image_type="Grayscale", n_points=60000, img="28x28",
        glimpse="5x5", steps=16,
        desc=(
            "In the MNISTLoc environment, the agent must localize a "
            "distinctive target patch within a handwritten-digit image: it "
            "observes its own glimpse plus the glimpse at the (unknown) "
            "target position, and predicts the target's normalized position."
        ),
        variants=[("MNISTLoc-train-v0", "Train split."),
                  ("MNISTLoc-test-v0", "Test split.")],
    ),
    "CIFAR10Loc": dict(
        base="CIFAR10", image_type="RGB", n_points=50000, img="32x32",
        glimpse="5x5", steps=16,
        desc=(
            "In the CIFAR10Loc environment, the agent must localize a "
            "distinctive target patch within a natural image by comparing its "
            "own glimpse with the target glimpse observation."
        ),
        variants=[("CIFAR10Loc-train-v0", "Train split."),
                  ("CIFAR10Loc-test-v0", "Test split.")],
    ),
    "TinyImageNetLoc": dict(
        base="TinyImageNet", image_type="RGB", n_points=100000, img="64x64",
        glimpse="10x10", steps=16,
        desc=(
            "In the TinyImageNetLoc environment, the agent must localize a "
            "distinctive 10x10 target patch within a 64x64 natural image."
        ),
        variants=[("TinyImageNetLoc-train-v0", "Train split."),
                  ("TinyImageNetLoc-test-v0", "Validation split.")],
    ),
}

LIDAR_IDS = {
    "LIDARLocMaze": dict(
        map_type="Maze", static="Dynamic", size="21x21",
        map_desc="Dynamic maze environment with different maps per episode.",
        desc=(
            "In the LIDARLocMaze environment, the agent faces a map with "
            "narrow corridors. Hence, it will always receive information from "
            "its LIDAR sensors, but many regions of the maze look alike. The "
            "agent must navigate around the map to gather information and "
            "localize itself. The maze layout changes every episode, so the "
            "agent has to learn to process the map it is provided as "
            "additional input."
        ),
    ),
    "LIDARLocMazeStatic": dict(
        map_type="Maze", static="Static", size="21x21",
        map_desc="Maze with static map.",
        desc=(
            "Static-map variant of LIDARLocMaze: the map stays constant, so "
            "the agent can memorize the layout over the course of training."
        ),
    ),
    "LIDARLocRooms": dict(
        map_type="Rooms", static="Dynamic", size="32x32",
        map_desc="Dynamic rooms environment with different maps per episode.",
        desc=(
            "In the LIDARLocRooms environment, the agent faces a map with "
            "wide open areas. Hence, often it might not receive any "
            "information from its LIDAR sensors if it is in the middle of a "
            "large room. The agent must navigate around the map to gather "
            "information and localize itself. The room layout changes every "
            "episode."
        ),
    ),
    "LIDARLocRoomsStatic": dict(
        map_type="Rooms", static="Static", size="32x32",
        map_desc="Rooms with static map.",
        desc=(
            "Static-map variant of LIDARLocRooms: the map stays constant, so "
            "the agent can memorize the layout over the course of training."
        ),
    ),
}


# ---------------------------------------------------------------------------
# Family base pages


def image_classification_base() -> str:
    sp = _gym_spaces("CircleSquare-v0")
    overview = [
        "| Environment ID | Image type | # data points | Image size "
        "| Glimpse size | Step limit | # classes | Image description |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, m in sorted(IMG_CLS_FAMILIES.items()):
        overview.append(
            f"| [{name}-v0]({name}.md) | {m['image_type']} | {m['n_points']} "
            f"| {m['img']} | {m['glimpse']} | {m['steps']} | {m['classes']} "
            f"| {m['img_desc']} |"
        )
    return f"""{HEADER_NOTE}# Image Classification Environments

In image classification environments, the agent has to classify an image by
moving a small glimpse around the image. The glimpse is never large enough to
see the entire image at once, so the agent has to move around to gather
information.

All image classification environments are instantiations of
`apx_torch.envs.image_classification.ImageClassificationEnv` (behavioral mirror of
the reference's `ImageClassificationVectorEnv`, image_classification.py:22-180)
and share the following properties:

{_properties_table(sp, 'CrossEntropyLossFn(num_classes=K).normalized')}

where $K$ is the number of classes, $G$ the glimpse size, and $C$ the number
of image channels (1 grayscale, 3 RGB).

## Action Space

The action is a `float32` vector in $[-1, 1]^2$ describing the relative
movement of the glimpse sensor. It is projected into the unit circle
(`project_sphere`, util.py:94-97) and scaled by `max_step_length` (default
0.2, i.e. 10% of the image per step).

## Prediction Space

The prediction is a `float32` vector in $\\mathbb{{R}}^K$ containing the
logits of the agent's class prediction.

## Prediction Target Space

The prediction target is the scalar integer true class in $\\{{0..K-1\\}}$.

## Observation Space

| Key | Type | Description |
|---|---|---|
| glimpse | `float32[G, G, C]` | the current glimpse, values in $[0, 1]$ |
| glimpse_pos | `float32[2]` | normalized glimpse position in $[-1, 1]^2$ |
| time_step | `float32` | normalized time $2t/T - 1$ |

Inverted variants additionally observe `inverted_label` (0/1 on the first
step of an episode, constant 2 afterwards,
image_perception_module.py:246-251).

## Rewards

The per-step reward is exactly

```
reward = -1e-3 * ||action||_2  -  normalized_cross_entropy(prediction, label)
```

where the cross entropy is normalized so a blind uniform guess scores 1
(loss_fn.py:69-83, :247-250). On the lockstep autoreset step the reward is 0
(image_perception_module.py:197-202).
{SPARSE_NOTE.format(sparse_id='CircleSquare-sparse-v0')}
## Starting State

The glimpse starts at a uniformly random position in $[-1, 1]^2$; a fresh
image batch is drawn i.i.d. with replacement from the dataset.

## Episode End

The episode terminates after `step_limit` steps (default 16). All
environments of one vector batch reset in lockstep once every environment
has terminated.

## Arguments

| Name | Type | Default | Description |
|---|---|---|---|
| `dataset` | `BankImageDataset` | | HBM-resident image bank |
| `sensor_size` | `tuple[int, int]` | `(5, 5)` | glimpse size in pixels |
| `sensor_scale` | `float` | `1.0` | glimpse-pixel to image-pixel ratio |
| `max_step_length` | `float` | `0.2` | max normalized movement per step |
| `step_limit` | `int` | `16` | episode length |
| `randomly_invert_labels` | `bool` | `False` | Inverted variants |

See [ImagePerceptionConfig](ImagePerceptionConfig.md) for the full list.

## Overview of Implemented Environments

{os.linesep.join(overview)}
"""


def image_localization_base() -> str:
    sp = _gym_spaces("TinyImageNetLoc-v0")
    overview = [
        "| Environment ID | Image type | # data points | Image size "
        "| Glimpse size | Step limit |",
        "|---|---|---|---|---|---|",
    ]
    for name, m in sorted(IMG_LOC_FAMILIES.items()):
        overview.append(
            f"| [{name}-v0]({name}.md) | {m['image_type']} | {m['n_points']} "
            f"| {m['img']} | {m['glimpse']} | {m['steps']} |"
        )
    return f"""{HEADER_NOTE}# Image Localization Environments

In image localization environments, the agent has to find a target position
within an image. Besides its own movable glimpse, it observes the glimpse at
the (unknown) target position and must predict the target's normalized
coordinates.

All image localization environments are instantiations of
`apx_torch.envs.image_localization.ImageLocalizationEnv` (mirror of the reference's
`ImageLocalizationVectorEnv`, image_localization.py:24-269):

{_properties_table(sp, 'MSELossFn(target_std=(high-low)/sqrt(12)).normalized')}

## Action Space

Same as image classification: unit-circle-projected relative glimpse
movement scaled by `max_step_length`.

## Prediction Space

The prediction is the estimated normalized target position in $[-1, 1]^2$.

## Prediction Target Space

The target position of the PREVIOUS step (the initial target on the first
step), normalized to $[-1, 1]^2$ (image_localization.py:151-152, :180).

## Observation Space

| Key | Type | Description |
|---|---|---|
| glimpse | `float32[G, G, C]` | the agent's current glimpse |
| glimpse_pos | `float32[2]` | normalized glimpse position |
| target_glimpse | `float32[G, G, C]` | the glimpse at the target position |
| time_step | `float32` | normalized time $2t/T - 1$ |

## Rewards

```
reward = -1e-3 * ||action||_2  -  3 * mean((prediction - target)^2)
```

The MSE is normalized by the variance of a uniform target distribution
((high - low)/sqrt(12))^2 = 1/3, so a blind guess scores 1 in expectation
(active_regression_env.py:29-52).
{SPARSE_NOTE.format(sparse_id='MNISTLoc-sparse-v0')}
## Starting State

The initial target is sampled by scoring a grid of candidate glimpses for
uniqueness (pairwise MSE; uniform choice among the top 10, plus jitter —
image_perception_module.py:253-292); on autoreset the target is resampled
uniformly in $[-1, 1]^2$ (image_localization.py:152-156). The glimpse starts
at a uniformly random position.

## Episode End

The episode terminates after `step_limit` steps (default 16); lockstep
autoreset as in image classification.

## Overview of Implemented Environments

{os.linesep.join(overview)}
"""


def lidar_base() -> str:
    sp = _gym_spaces("LIDARLocRooms-v0")
    overview = [
        "| Environment ID | Map type | Static/dynamic | Map size | Map description |",
        "|---|---|---|---|---|",
    ]
    for name, m in sorted(LIDAR_IDS.items()):
        overview.append(
            f"| [{name}-v0]({name}.md) | {m['map_type']} | {m['static']} "
            f"| {m['size']} | {m['map_desc']} |"
        )
    return f"""{HEADER_NOTE}# 2D LIDAR Localization Environments

In the 2D LIDAR localization environments, the agent is placed at a random
location in a 2D occupancy-grid map and must predict its own position. Per
step it receives distance readings from an 8-beam LIDAR sensor (range 5
cells) and exact odometry relative to its starting position. Static-map
variants keep one fixed map; dynamic variants draw a fresh procedurally
generated map every episode and expose it as an additional observation.

All LIDAR environments are instantiations of
`apx_torch.envs.lidar_localization.LIDARLocalizationEnv` (mirror of the
reference's `LIDARLocalization2DEnv`, lidar_localization2d.py:24-565),
wrapped in `TimeLimit(100, issue_termination=True)`:

{_properties_table(sp, 'MSELossFn(target_std=(high-low)/sqrt(12)).normalized')}

where $M$ is the map side length. The `"map"` key is only included in the
dynamic environments.

## Action Space

The action is a `float32` vector in $[-1, 1]^2$ describing the agent's
relative movement in cells; it is normalized into the unit circle when its
magnitude exceeds 1 (lidar_localization2d.py:332-335). Movement stops
1e-3 before the first wall hit and then slides along axis-aligned walls
(:336-364).

## Prediction Space

The predicted normalized agent position in $[-1, 1]^2$.

## Prediction Target Space

The agent's PREVIOUS position, normalized as `pos / map_size * 2 - 1`
(:377, :388).

## Observation Space

| Key | Type | Description |
|---|---|---|
| lidar | `float32[8]` | beam distances / range, clipped to $[0, 1]$ |
| odometry | `float32[2]` | displacement from the episode origin / map size |
| map | `float32[M, M, 1]` | occupancy bitmap (dynamic variants only) |
| time_step | `float32` | normalized time $2t/T - 1$ |

## Rewards

```
reward = 0.1 - 1e-3 * sum(action^2)  -  3 * mean((prediction - target)^2)
```

The 0.1 constant discourages ending the episode early by walking out of
bounds (:329-330); the MSE normalization is the uniform-distribution rule.
{SPARSE_NOTE.format(sparse_id='LIDARLocRooms-sparse-v0')}
## Starting State

The agent starts at the center of a uniformly drawn free cell (:303-311).
Dynamic variants draw a fresh map per episode from the procedural
maze/rooms generators, seeded by the drawn dataset index.

## Episode End

The episode ends with the TERMINATE flag (issue_termination=True) after 100
steps, or earlier if the agent leaves the map bounds (:366-375 — only
reachable on maps with open borders).

## Arguments

| Name | Type | Default | Description |
|---|---|---|---|
| `map_bank` | `MapBank` | | HBM-resident bank of occupancy maps |
| `static_map` | `bool` | `False` | fixed map vs fresh map per episode |
| `static_map_pos` | `int` | `0` | bank position used when static |
| `lidar_beam_count` | `int` | `8` | number of beams |
| `lidar_range` | `float` | `5` | maximum beam range in cells |

## Overview of Implemented Environments

{os.linesep.join(overview)}
"""


def light_dark_page() -> str:
    sp = _gym_spaces("LightDark-v0")
    return f"""{HEADER_NOTE}# LightDark

{_gif('LightDark-v0')}## Description

In the LightDark environment, the agent must estimate its position based on
noisy observations, where the noise level depends on the brightness of the
surrounding area. A point light source sits at (0, -0.7) at height 0.2;
brightness falls off as $h^2 / (d^2 + h^2)$, and the observation noise std
is $(1 - \\textit{{brightness}}) \\cdot 0.3$ (light_dark.py:96-110). The
agent can move to brighter areas to obtain more reliable observations
before committing to predictions.

{_properties_table(sp, 'MSELossFn(target_std=(high-low)/sqrt(12)).normalized')}

## Action Space

The action is a `float32` vector in $[-1, 1]^2$; the agent moves 0.15 times
the unit-normalized action per step (light_dark.py:136-140).

## Prediction Space

The predicted agent position in $[-1, 1]^2$.

## Prediction Target Space

The agent's PREVIOUS position (light_dark.py:150).

## Observation Space

| Key | Type | Description |
|---|---|---|
| noisy_position | `float32[2]` | position + Gaussian noise, clipped to $[-2, 2]$ |
| time_step | `float32` | normalized time $2t/T - 1$ |

## Rewards

```
reward = 1.0 - 1e-3 * sum(action^2)  -  3 * mean((prediction - target)^2)
```

(The docstring of the reference claims a 0.1 constant; the code uses 1.0,
light_dark.py:134 — the implementation is authoritative and replicated.)
{SPARSE_NOTE.format(sparse_id='LightDark-sparse-v0')}
## Starting State

The agent starts uniformly in $[-1, 1]^2$ (light_dark.py:112-121).

## Episode End

Terminates when $|pos_i| \\ge 1$ for any axis (:141-144), or via
`TimeLimit(50, issue_termination=True)`.

{_example_usage('LightDark-v0')}
"""


def image_perception_config_page() -> str:
    return f"""{HEADER_NOTE}# ImagePerceptionConfig

Configuration of the image perception environments
(`apx_torch.envs.image_perception.ImagePerceptionParams`, mirror of the
reference's `ImagePerceptionConfig`, image_perception_module.py:20-34).

| Parameter | Type | Default | Description |
|---|---|---|---|
| `dataset` | `BankImageDataset` | | HBM-resident image bank (procedural CircleSquare or packed HuggingFace corpus) |
| `sensor_size` | `tuple[int, int]` | `(5, 5)` | glimpse sensor size in pixels |
| `sensor_scale` | `float` | `1.0` | glimpse-pixel to image-pixel ratio (2 = glimpse pixels twice as large) |
| `max_step_length` | `float` | `0.2` | max normalized sensor movement per step relative to image size |
| `step_limit` | `int` | `16` | steps per episode before termination |
| `randomly_invert_labels` | `bool` | `False` | per-episode label inversion (Inverted variants) |
| `unique_sampling_top_k` | `int` | `10` | localization target sampler: uniform pick among the top-k most unique candidates |
| `unique_sampling_max_grid_cell_size_rel` | `float` | `0.2` | candidate grid resolution |
| `display_visitation` | `bool` | `True` | render glimpse visitation history |
| `render_unvisited_opacity` | `float` | `0.0` | render overlay opacity (unvisited) |
| `render_visited_opacity` | `float` | `0.3` | render overlay opacity (visited) |

Prefetching knobs of the reference (`prefetch`, `prefetch_buffer_size`) do
not exist here: datasets are HBM-resident banks, so there is no per-episode
host I/O to hide.
"""


# ---------------------------------------------------------------------------
# Per-family ID pages


def img_cls_page(name: str, m: dict) -> str:
    head = _kv_table([
        ("Environment ID", f"{name}-v0"),
        ("Image type", m["image_type"]),
        ("# data points", str(m["n_points"])),
        ("Image size", m["img"]),
        ("Glimpse size", m["glimpse"]),
        ("Step limit", str(m["steps"])),
        ("# classes", str(m["classes"])),
        ("Image description", m["img_desc"]),
    ])
    return f"""{HEADER_NOTE}# {name}

{_gif(f'{name}-v0')} This environment is part of the Image Classification Environments. Refer to
the [Image Classification Environments overview](ImageClassificationVectorEnv.md)
for a general description of these environments.

{head}
## Description

{m['desc']}

{_example_usage(f'{name}-v0')}
{_variants_table(m.get('variants', []))}"""


def img_loc_page(name: str, m: dict) -> str:
    head = _kv_table([
        ("Environment ID", f"{name}-v0"),
        ("Image type", m["image_type"]),
        ("# data points", str(m["n_points"])),
        ("Image size", m["img"]),
        ("Glimpse size", m["glimpse"]),
        ("Step limit", str(m["steps"])),
    ])
    return f"""{HEADER_NOTE}# {name}

{_gif(f'{name}-v0')} This environment is part of the Image Localization Environments. Refer to
the [Image Localization Environments overview](ImageLocalizationVectorEnv.md)
for a general description of these environments.

{head}
## Description

{m['desc']}

{_example_usage(f'{name}-v0')}
{_variants_table(m.get('variants', []))}"""


def lidar_page(name: str, m: dict) -> str:
    head = _kv_table([
        ("Environment ID", f"{name}-v0"),
        ("Map type", m["map_type"]),
        ("Static/dynamic", m["static"]),
        ("Map size", m["size"]),
        ("Map description", m["map_desc"]),
    ])
    return f"""{HEADER_NOTE}# {name}

{_gif(f'{name}-v0')} This environment is part of the 2D LIDAR Localization Environments. Refer to
the [2D LIDAR Localization Environments overview](LIDARLocalization2DEnv.md)
for a general description of these environments.

{head}
## Description

{m['desc']}

{_example_usage(f'{name}-v0')}
"""


# ---------------------------------------------------------------------------


def generate(out: str, device="cuda") -> list[str]:
    os.makedirs(out, exist_ok=True)
    _OUT_DIR["path"] = out
    _DEVICE["device"] = device
    pages = {
        "ImageClassificationVectorEnv.md": image_classification_base(),
        "ImageLocalizationVectorEnv.md": image_localization_base(),
        "LIDARLocalization2DEnv.md": lidar_base(),
        "ImagePerceptionConfig.md": image_perception_config_page(),
        "LightDark.md": light_dark_page(),
    }
    for name, m in IMG_CLS_FAMILIES.items():
        pages[f"{name}.md"] = img_cls_page(name, m)
    for name, m in IMG_LOC_FAMILIES.items():
        pages[f"{name}.md"] = img_loc_page(name, m)
    for name, m in LIDAR_IDS.items():
        pages[f"{name}.md"] = lidar_page(name, m)

    import apx_torch

    all_ids = sorted(apx_torch.env_ids())
    index = [
        HEADER_NOTE + "# Environment catalog",
        "",
        "Family overviews:",
        "",
        "- [Image Classification](ImageClassificationVectorEnv.md)",
        "- [Image Localization](ImageLocalizationVectorEnv.md)",
        "- [2D LIDAR Localization](LIDARLocalization2DEnv.md)",
        "- [LightDark](LightDark.md)",
        "- [ImagePerceptionConfig](ImagePerceptionConfig.md)",
        "",
        f"All {len(all_ids)} registered ids (every base id has a "
        "`-sparse-v0` twin):",
        "",
    ]
    for i in all_ids:
        index.append(f"- `{i}`")
    pages["README.md"] = "\n".join(index) + "\n"

    for fname, content in pages.items():
        with open(os.path.join(out, fname), "w") as f:
            f.write(content)
    return sorted(pages)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/envs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    written = generate(args.out, args.device)
    print(f"wrote {len(written)} pages to {args.out}")


if __name__ == "__main__":
    main()

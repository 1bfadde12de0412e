"""Shared glimpse-on-image engine of the image envs, batched over envs
(counterpart of apx.envs.image_perception).

Same semantics as apx's engine (after ap_gym's image_perception_module):
  * the action is projected into the unit disc, scaled by
    ``max_step_length``, added to the normalized position and clipped to
    [-1, 1]^2;
  * base_reward = -1e-3 |action| of the raw action;
  * an episode terminates when its time reaches ``step_limit``;
  * obs = {glimpse, glimpse_pos, time_step[, inverted_label]} with
    time_step = 2 t / step_limit - 1; inverted_label is 0/1 at t = 0 and 2
    afterwards;
  * a reset draws one dataset index, the label inversion and a start
    position uniform in [-1, 1)^2.

Every glimpse, of a step and of a reset, goes through K3
(``apx_torch.ops.glimpse_cuda``), but under apx's ``glimpse_window="rows"``
(below). apx's ``image_storage`` switch says how the state carries the
episode's image; all four modes give the same trajectories:

* ``"array"`` (``"auto"``, apx's default): (N, H, W, C) in the bank's dtype;
* ``"packed"``: the uint8 row as (N, H*W*C/4) int32 words (banks whose rows
  pack); K3 reads the words' bytes in place (a uint8 view, no unpack);
* ``"flat"``: (N, H*W*C) in the bank's dtype, a reshape for K3;
* ``"gather"``: no image (an (N, 0) leaf); K3 reads the bank's row
  ``data_index`` through its index argument, every glimpse.

``image_raw`` gives the logical (N, H, W, C) image under any mode.
``glimpse_window="rows"`` runs apx's row-band form
(``ops.glimpse.extract_glimpse_batch(window="rows")``), bitwise the plain
``"off"`` form; it is apx's XLA form, plain PyTorch on the card too, and
``"auto"`` resolves to ``"off"`` as in apx.

The unique-target sampler (the image localization envs' explicit reset)
ranks a grid of candidate positions by how unlike their glimpses are to
every other candidate's: the uniqueness of candidate i is
``min over j != i of mse(glimpse_i, glimpse_j)``, from a Gram product
``(|a|^2 + |b|^2 - 2 a.b) / d`` in row blocks of 128, and the target is a
uniform pick among the ``unique_sampling_top_k`` most unique, jittered by
up to one grid cell. apx's ``unique_sampling_backend`` picks how the
scores are computed:

* ``"cartesian"`` (``"auto"``): the candidate glimpses from apx's cartesian
  factorization (the row product once per candidate row, reused across
  the columns), all P at once, then the Gram rows;
* ``"chunked"``: each candidate's glimpse through K3, 27 candidates per
  launch (the image read through K3's index), then the Gram rows;
* ``"streamed"``: no (N, P, d) buffer: the column blocks of the cartesian
  factors are recomputed per pair of grid columns, with a running min over
  the (c1, c1) Gram blocks; memory is the (N, c1, s0, C, W) intermediate
  and two (N, c1, d) blocks (apx's route to TinyImageNetLoc at N=16384).

The products are library matmuls, as in apx (plain ``jnp`` there,
outside any Pallas kernel), in full float32: TF32 is switched off inside
the sweep. apx's ``glimpse_precision`` is a TPU MXU setting and a no-op on
its CPU; the port accepts its values and computes in float32 for all of
them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..core.numerics import fma, matmul_tf32, time_obs
from ..core.spaces import Box, DictSpace, Discrete, Image
from ..data.dataset import ImageDataset, unpack_rows
from ..ops.geometry import norm2, project_sphere
from ..ops.glimpse import extract_glimpse_batch, interp_weights, sensor_pos_lim_pixels
from ..ops.glimpse_cuda import glimpse

__all__ = ["ImagePerceptionParams", "ImagePerceptionState", "ImagePerceptionEngine",
           "IMAGE_STORAGES", "SAMPLERS"]

IMAGE_STORAGES = ("auto", "array", "packed", "flat", "gather")
SAMPLERS = ("auto", "cartesian", "chunked", "streamed")
CHUNK = 27  # candidates per chunk of the "chunked" sampler (apx's)


@dataclasses.dataclass(frozen=True, eq=False)
class ImagePerceptionParams:
    """apx's ImagePerceptionParams: the fields the image envs read, the
    sampler's, and apx's render-only ones (carried, not read)."""

    dataset: ImageDataset
    sensor_size: tuple[int, int] = (5, 5)
    sensor_scale: float = 1.0
    max_step_length: tuple[float, float] = (0.2, 0.2)
    step_limit: int = 16
    randomly_invert_labels: bool = False
    unique_sampling_max_grid_cell_size_rel: float = 0.2
    unique_sampling_top_k: int = 10
    unique_sampling_backend: str = "auto"
    glimpse_precision: str = "default"
    # apx's A/B switches: "auto" resolves to what apx resolves it to.
    glimpse_window: str = "auto"
    image_storage: str = "auto"
    display_visitation: bool = True
    render_unvisited_opacity: float = 0.0
    render_visited_opacity: float = 0.3

    def __post_init__(self):
        if self.unique_sampling_backend not in SAMPLERS:
            raise ValueError(
                f"unknown unique_sampling_backend {self.unique_sampling_backend!r}; "
                "expected 'auto', 'cartesian', 'chunked' or 'streamed'"
            )
        if self.glimpse_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"unknown glimpse_precision {self.glimpse_precision!r}; "
                "expected 'default', 'high' or 'highest'"
            )
        if self.glimpse_window not in ("auto", "off", "rows"):
            raise ValueError(f"unknown glimpse_window {self.glimpse_window!r}; "
                             "expected 'auto', 'off' or 'rows'")
        ImagePerceptionEngine.storage(self)  # raises apx's ValueError on a bad mode

    @property
    def device(self) -> torch.device:
        return self.dataset.device

    @functools.cached_property
    def max_step(self) -> torch.Tensor:
        """(2,) float32 max step per axis."""
        return torch.tensor(self.max_step_length, dtype=torch.float32, device=self.device)


@dataclasses.dataclass
class ImagePerceptionState:
    # The episode's image in the form of params.image_storage: (N, H, W, C)
    # ("array"), (N, R) int32 words ("packed"), (N, H*W*C) ("flat") or an
    # (N, 0) placeholder ("gather"); ImagePerceptionEngine.image_raw gives
    # the logical image.
    image: torch.Tensor
    label: torch.Tensor  # (N,) int64
    data_index: torch.Tensor  # (N,) int64
    pos: torch.Tensor  # (N, 2) float32 normalized (x, y)
    time: torch.Tensor  # (N,) int32
    label_inverted: torch.Tensor  # (N,) bool


class ImagePerceptionEngine:
    """Stateless helper implementing the shared mechanics."""

    @staticmethod
    def observation_space_dict(params: ImagePerceptionParams) -> dict[str, Any]:
        s0, s1 = params.sensor_size
        _, _, c = params.dataset.image_shape
        d: dict[str, Any] = {
            "glimpse": Image.create(width=s1, height=s0, channels=c),
            "glimpse_pos": Box(low=-1.0, high=1.0, shape=(2,)),
            "time_step": Box(low=-1.0, high=1.0, shape=()),
        }
        if params.randomly_invert_labels:
            d["inverted_label"] = Discrete(3)
        return d

    @staticmethod
    def observation_space(params: ImagePerceptionParams) -> DictSpace:
        return DictSpace(ImagePerceptionEngine.observation_space_dict(params))

    @staticmethod
    def inner_action_space(params: ImagePerceptionParams) -> Box:
        return Box(low=-1.0, high=1.0, shape=(2,))

    @staticmethod
    def storage(params: ImagePerceptionParams) -> str:
        """The resolved ``image_storage`` mode: "array" for "auto"."""
        mode = params.image_storage
        if mode not in IMAGE_STORAGES:
            raise ValueError(f"unknown image_storage {mode!r}; "
                             "expected 'auto', 'packed', 'array', 'flat' or 'gather'")
        if mode == "packed" and params.dataset.stored_packed_shape is None:
            raise ValueError("image_storage='packed' requires an int32-packed bank")
        return "array" if mode == "auto" else mode

    @staticmethod
    def resolved_glimpse_window(params: ImagePerceptionParams) -> str:
        """``glimpse_window`` with "auto" resolved to "off", as in apx."""
        return "off" if params.glimpse_window == "auto" else params.glimpse_window

    @staticmethod
    def fetch_state_image(idx: torch.Tensor,
                          params: ImagePerceptionParams) -> tuple[torch.Tensor, torch.Tensor]:
        """(image-state leaf, label) of dataset indices ``idx`` (N,), in the
        form the resolved storage mode carries."""
        mode = ImagePerceptionEngine.storage(params)
        ds = params.dataset
        if mode == "gather":
            return torch.zeros((idx.shape[0], 0), dtype=torch.uint8, device=idx.device), \
                ds.fetch_label(idx)
        if mode == "packed":
            return ds.fetch_stored(idx)
        img, label = ds.fetch_raw(idx)
        if mode == "flat":
            img = img.reshape(img.shape[0], -1)
        return img, label

    @staticmethod
    def image_raw(state: ImagePerceptionState, params: ImagePerceptionParams) -> torch.Tensor:
        """The logical (N, H, W, C) image in the bank's dtype, whatever the
        storage mode."""
        mode = ImagePerceptionEngine.storage(params)
        shape = tuple(params.dataset.image_shape)
        if mode == "gather":
            return params.dataset.fetch_raw(state.data_index)[0]
        if mode == "packed":
            return unpack_rows(state.image, shape)
        if mode == "flat":
            return state.image.reshape(state.image.shape[0], *shape)
        return state.image

    @staticmethod
    def glimpse_source(state: ImagePerceptionState,
                       params: ImagePerceptionParams) -> tuple[torch.Tensor, torch.Tensor | None]:
        """What K3 reads for the state's glimpses, with no copy: (images,
        None) with images (N, H, W, C), or (bank images (D, H, W, C),
        data_index) under "gather". A packed row's words are viewed as their
        bytes, which are the unpacked image's."""
        mode = ImagePerceptionEngine.storage(params)
        shape = tuple(params.dataset.image_shape)
        n = state.pos.shape[0]
        if mode == "gather":
            bank = params.dataset.glimpse_images()
            if bank is None:  # a procedural dataset: synthesize the rows
                return params.dataset.fetch_raw(state.data_index)[0], None
            return bank, state.data_index
        if mode == "packed":
            return state.image.view(torch.uint8).reshape(n, *shape), None
        if mode == "flat":
            return state.image.reshape(n, *shape), None
        return state.image, None

    @staticmethod
    def draw_reset(num_envs: int, params: ImagePerceptionParams,
                   generator: torch.Generator) -> dict[str, torch.Tensor]:
        """index ~ U[0, D), inverted ~ Bernoulli(1/2) when labels are
        randomly inverted (else False), pos ~ U[-1, 1)^2."""
        dev = params.device
        index = torch.randint(0, params.dataset.length, (num_envs,), generator=generator,
                              device=dev)
        if params.randomly_invert_labels:
            inverted = torch.randint(0, 2, (num_envs,), generator=generator, device=dev) == 1
        else:
            inverted = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        pos = torch.rand((num_envs, 2), generator=generator, device=dev) * 2.0 - 1.0
        return {"index": index, "inverted": inverted, "pos": pos}

    @staticmethod
    def reset_from_draws(draws: dict[str, torch.Tensor],
                         params: ImagePerceptionParams) -> ImagePerceptionState:
        dev = params.device
        idx = torch.as_tensor(draws["index"], device=dev).to(torch.int64)
        image, label = ImagePerceptionEngine.fetch_state_image(idx, params)
        inverted = torch.as_tensor(draws["inverted"], device=dev).to(torch.bool)
        if params.randomly_invert_labels:
            label = torch.where(inverted, params.dataset.num_classes - label - 1, label)
        else:
            inverted = torch.zeros_like(inverted)
        pos = torch.as_tensor(draws["pos"], device=dev).to(torch.float32)
        return ImagePerceptionState(
            image=image,
            label=label,
            data_index=idx,
            pos=pos,
            time=torch.zeros(idx.shape[0], dtype=torch.int32, device=dev),
            label_inverted=inverted,
        )

    @staticmethod
    def move(state: ImagePerceptionState, action: torch.Tensor, params: ImagePerceptionParams):
        """Returns (new_state, base_reward, terminated). The jitted reference
        contracts ``pos + max_step * proj`` into one FMA."""
        pos = fma(params.max_step, project_sphere(action), state.pos).clamp(-1.0, 1.0)
        base_reward = -norm2(action) * 1e-3
        time = state.time + 1
        terminated = time >= params.step_limit
        return dataclasses.replace(state, pos=pos, time=time), base_reward, terminated

    @staticmethod
    def glimpses(images: torch.Tensor, pos: torch.Tensor, params: ImagePerceptionParams,
                 index: torch.Tensor | None = None) -> torch.Tensor:
        """(N, s0, s1, C) glimpses at ``pos`` (N, 2) of ``images`` (or of
        ``images[index]``): K3, or under ``glimpse_window="rows"`` apx's row
        band, plain PyTorch on every device."""
        if ImagePerceptionEngine.resolved_glimpse_window(params) == "rows":
            return extract_glimpse_batch(images if index is None else images[index], pos,
                                         params.sensor_size, params.sensor_scale, window="rows")
        return glimpse(images, pos, params.sensor_size, params.sensor_scale, index=index)

    @staticmethod
    def get_glimpse(state: ImagePerceptionState, pos: torch.Tensor,
                    params: ImagePerceptionParams) -> torch.Tensor:
        images, index = ImagePerceptionEngine.glimpse_source(state, params)
        return ImagePerceptionEngine.glimpses(images, pos, params, index)

    @staticmethod
    def observe(state: ImagePerceptionState, params: ImagePerceptionParams) -> dict[str, torch.Tensor]:
        obs = {
            "glimpse": ImagePerceptionEngine.get_glimpse(state, state.pos, params),
            "glimpse_pos": state.pos,
            "time_step": time_obs(state.time, params.step_limit),
        }
        if params.randomly_invert_labels:
            obs["inverted_label"] = torch.where(
                state.time > 0, 2, state.label_inverted.to(torch.int32)
            ).to(torch.int32)
        return obs

    @staticmethod
    def info(state: ImagePerceptionState) -> dict[str, torch.Tensor]:
        return {"index": state.data_index}

    # ---- the unique-target sampler ----------------------------------------
    @staticmethod
    def _candidate_axes_np(params: ImagePerceptionParams):
        """Host float64 axes of the candidate grid, xs (c0,) and ys (c1,),
        and the (2,) largest cell: cells no wider than
        ``unique_sampling_max_grid_cell_size_rel`` sensors, so each axis has
        ``ceil(2 / max_cell)`` points (apx's rules, copied)."""
        h, w, _ = params.dataset.image_shape
        s0, s1 = params.sensor_size
        eff = np.array([s0, s1]) * params.sensor_scale
        lim = np.array([(w - 1) / 2 - (eff[0] - 1) / 2, (h - 1) / 2 - (eff[1] - 1) / 2])
        max_cell = eff / lim * params.unique_sampling_max_grid_cell_size_rel
        counts = np.ceil(2.0 / max_cell).astype(int)
        return np.linspace(-1, 1, counts[0]), np.linspace(-1, 1, counts[1]), max_cell

    @staticmethod
    def candidate_grid(params: ImagePerceptionParams) -> tuple[torch.Tensor, torch.Tensor]:
        """(P, 2) float32 candidate positions, candidate k = i * c1 + j at
        (xs[i], ys[j]), and the (2,) float32 largest cell, on the device."""
        xs, ys, max_cell = ImagePerceptionEngine._candidate_axes_np(params)
        grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
        dev = params.device
        return (torch.from_numpy(grid.astype(np.float32)).to(dev),
                torch.from_numpy(max_cell.astype(np.float32)).to(dev))

    @staticmethod
    def candidate_axes(params: ImagePerceptionParams) -> tuple[np.ndarray, np.ndarray]:
        """The grid's axes as float32, xs (c0,) and ys (c1,): candidate
        ``i * c1 + j`` of ``candidate_grid`` is exactly (xs[i], ys[j])."""
        xs, ys, _ = ImagePerceptionEngine._candidate_axes_np(params)
        return xs.astype(np.float32), ys.astype(np.float32)

    @staticmethod
    def _candidate_weights(params: ImagePerceptionParams) -> tuple[torch.Tensor, torch.Tensor]:
        """The hat weights of the candidates' sample rows, (c1, s0, H), and
        columns, (c0, s1, W). The centre pixels ``xs * lim + (W - 1) / 2``
        are computed on the host in float32 with two roundings: XLA folds
        them into constants of apx's jitted sweep, multiply and add apart."""
        h, w, _ = params.dataset.image_shape
        s0, s1 = params.sensor_size
        xs, ys = ImagePerceptionEngine.candidate_axes(params)
        lim = sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale)
        x_pix = xs * lim[0] + np.float32((w - 1) / 2.0)
        y_pix = ys * lim[1] + np.float32((h - 1) / 2.0)
        scale = np.float32(params.sensor_scale)
        off0 = (np.arange(s0, dtype=np.float32) - np.float32((s0 - 1) / 2.0)) * scale
        off1 = (np.arange(s1, dtype=np.float32) - np.float32((s1 - 1) / 2.0)) * scale
        dev = params.device
        rows = torch.from_numpy(y_pix[:, None] + off0[None, :]).to(dev)  # (c1, s0)
        cols = torch.from_numpy(x_pix[:, None] + off1[None, :]).to(dev)  # (c0, s1)
        return interp_weights(rows, h), interp_weights(cols, w)

    @staticmethod
    def _cartesian_factors(image: torch.Tensor, params: ImagePerceptionParams):
        """apx's cartesian factorization of the candidate sweep: glimpse rows
        depend only on a candidate's y and columns only on its x, so the row
        product runs once per candidate row. Returns the row-contracted
        images (N, c1, s0, W, C) and the column weights (c0, s1, W). A uint8
        image is scaled by ``f32(1 / 255)``, the reciprocal multiply XLA
        makes of apx's ``/ 255`` here."""
        n, h, w, c = image.shape
        s0 = params.sensor_size[0]
        w_rows, w_cols = ImagePerceptionEngine._candidate_weights(params)
        c1 = w_rows.shape[0]
        img = image.to(torch.float32)
        if image.dtype == torch.uint8:
            img = img * float(np.float32(1.0) / np.float32(255.0))
        tmp = torch.matmul(w_rows.reshape(c1 * s0, h), img.reshape(n, h, w * c))
        return tmp.reshape(n, c1, s0, w, c), w_cols

    @staticmethod
    def _candidate_flat(image: torch.Tensor, params: ImagePerceptionParams) -> torch.Tensor:
        """(N, P, d) candidate glimpses of images (N, H, W, C), flattened in
        (s0, s1, C) order, P in ``candidate_grid`` order, clipped to [0, 1]:
        the column product of ``_cartesian_factors``' intermediate forms
        every candidate."""
        tmp, w_cols = ImagePerceptionEngine._cartesian_factors(image, params)
        n, c1, s0, w, c = tmp.shape
        c0, s1 = w_cols.shape[:2]
        g = torch.matmul(tmp.transpose(3, 4), w_cols.reshape(c0 * s1, w).T)  # (N, c1, s0, C, c0 s1)
        g = g.reshape(n, c1, s0, c, c0, s1).permute(0, 4, 1, 2, 5, 3)  # (N, c0, c1, s0, s1, C)
        return g.reshape(n, c0 * c1, s0 * s1 * c).clamp_(0.0, 1.0)  # one copy, clipped in place

    @staticmethod
    def _min_pairwise_mse(flat: torch.Tensor) -> torch.Tensor:
        """(N, P) uniqueness: for each candidate the least mean squared
        difference to any other candidate, from Gram rows in blocks of 128
        (the min is exact, so the blocks do not change it). The mean is
        ``* f32(1 / d)``, the reciprocal multiply XLA makes of apx's
        ``/ d``; the diagonal is masked with inf."""
        n, p, d = flat.shape
        inv_d = float(np.float32(1.0) / np.float32(d))
        sq = (flat * flat).sum(dim=-1)  # (N, P)
        col = torch.arange(p, device=flat.device)
        out = torch.empty((n, p), dtype=flat.dtype, device=flat.device)
        for b0 in range(0, p, 128):
            b1 = min(p, b0 + 128)
            g = torch.matmul(flat[:, b0:b1], flat.transpose(1, 2))  # (N, pb, P)
            # (sq_i + sq_j - 2 g) * inv_d, in place where the rounding allows.
            diff = sq[:, b0:b1, None] + sq[:, None, :]
            diff.sub_(g.mul_(2.0)).mul_(inv_d)
            diag = torch.arange(b0, b1, device=flat.device)[:, None] == col[None, :]
            out[:, b0:b1] = diff.masked_fill_(diag, float("inf")).amin(dim=-1)
        return out

    @staticmethod
    def _candidate_flat_chunked(image: torch.Tensor,
                                params: ImagePerceptionParams) -> torch.Tensor:
        """(N, P, d) candidate glimpses, each extracted on its own (apx's
        per-candidate form), CHUNK candidates of every env per K3 launch:
        the launch reads image n for its glimpses n * CHUNK + c through K3's
        index, so no image is copied."""
        n = image.shape[0]
        candidates, _ = ImagePerceptionEngine.candidate_grid(params)
        p = candidates.shape[0]
        index = torch.arange(n, device=image.device).repeat_interleave(CHUNK)
        out = []
        for c0 in range(0, p, CHUNK):
            cand = candidates[c0:c0 + CHUNK]
            k = cand.shape[0]
            idx = index if k == CHUNK else torch.arange(n, device=image.device).repeat_interleave(k)
            g = ImagePerceptionEngine.glimpses(image, cand.repeat(n, 1), params, idx)
            out.append(g.reshape(n, k, -1))
        return torch.cat(out, dim=1)

    @staticmethod
    def _unique_scores_streamed(image: torch.Tensor,
                                params: ImagePerceptionParams) -> torch.Tensor:
        """(N, P) uniqueness without the (N, P, d) candidate buffer: the
        column block of grid column i, (N, c1, d) glimpses, is recomputed
        from the cartesian factors whenever it is needed, and a running min
        is kept over the (c1, c1) Gram blocks of every pair of columns (i,
        j), the diagonal masked only where i == j. The factors are kept as
        (N, c1, s0, C, W), so a column block is one product over W into
        (s0, C, s1) order: the Gram sums run over the same d terms as the
        cartesian form's (s0, s1, C) order, summed in another order."""
        n, h, w, c = image.shape
        w_rows, w_cols = ImagePerceptionEngine._candidate_weights(params)
        c1, s0 = w_rows.shape[:2]
        c0, s1 = w_cols.shape[:2]
        d = s0 * s1 * c
        inv_d = float(np.float32(1.0) / np.float32(d))
        img = image.to(torch.float32)
        if image.dtype == torch.uint8:
            img = img * float(np.float32(1.0) / np.float32(255.0))
        img = img.permute(0, 1, 3, 2).reshape(n, h, c * w)  # (N, H, C W)
        tmp = torch.matmul(w_rows.reshape(c1 * s0, h), img).reshape(-1, w)  # (N c1 s0 C, W)
        del img

        def block(i):
            return torch.matmul(tmp, w_cols[i].T).reshape(n, c1, d).clamp_(0.0, 1.0)

        sq = torch.stack([(b * b).sum(-1) for b in map(block, range(c0))], 1)  # (N, c0, c1)
        eye = torch.eye(c1, dtype=torch.bool, device=image.device)
        out = torch.empty((n, c0, c1), dtype=torch.float32, device=image.device)
        for i in range(c0):
            fb = block(i)
            run = torch.full((n, c1), float("inf"), device=image.device)
            for j in range(c0):
                g = torch.matmul(fb, (fb if j == i else block(j)).transpose(1, 2))  # (N, c1, c1)
                mse = sq[:, i, :, None] + sq[:, j, None, :]
                mse.sub_(g.mul_(2.0)).mul_(inv_d)
                if j == i:
                    mse.masked_fill_(eye, float("inf"))
                run = torch.minimum(run, mse.amin(-1))
            out[:, i] = run
        return out.reshape(n, c0 * c1)  # candidate_grid order k = i * c1 + j

    @staticmethod
    def uniqueness(image: torch.Tensor, params: ImagePerceptionParams) -> torch.Tensor:
        """(N, P) uniqueness scores of the candidates of images (N, H, W, C),
        computed in full float32 (TF32 off), by the params' sampler."""
        backend = params.unique_sampling_backend
        with matmul_tf32(False):
            if backend == "streamed":
                return ImagePerceptionEngine._unique_scores_streamed(image, params)
            if backend == "chunked":
                flat = ImagePerceptionEngine._candidate_flat_chunked(image, params)
            else:
                flat = ImagePerceptionEngine._candidate_flat(image, params)
            return ImagePerceptionEngine._min_pairwise_mse(flat)

    @staticmethod
    def unique_target_top_k(image: torch.Tensor, params: ImagePerceptionParams) -> torch.Tensor:
        """(N, top_k) candidate indices, most unique first; ties keep the
        lower index (a stable sort, as ``jnp.argsort``)."""
        u = ImagePerceptionEngine.uniqueness(image, params)
        return torch.argsort(-u, dim=-1, stable=True)[:, :params.unique_sampling_top_k]

    @staticmethod
    def unique_target_from_draws(image: torch.Tensor, sel: torch.Tensor, jitter: torch.Tensor,
                                 params: ImagePerceptionParams) -> torch.Tensor:
        """(N, 2) float32 targets: the ``sel``-th (N,) most unique
        candidate, plus ``jitter`` (N, 2), clipped to [-1, 1]."""
        candidates, _ = ImagePerceptionEngine.candidate_grid(params)
        top = ImagePerceptionEngine.unique_target_top_k(image, params)
        pick = top.gather(1, sel.to(torch.int64)[:, None])[:, 0]
        return (candidates[pick] + jitter).clamp(-1.0, 1.0)

    @staticmethod
    def draw_unique_target(num_envs: int, params: ImagePerceptionParams,
                           generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The sampler's draws: ``sel`` uniform in [0, top_k) and ``jitter``
        uniform in [-max_cell, max_cell)^2."""
        _, max_cell = ImagePerceptionEngine.candidate_grid(params)
        dev = params.device
        sel = torch.randint(0, params.unique_sampling_top_k, (num_envs,), generator=generator,
                            device=dev)
        u = torch.rand((num_envs, 2), generator=generator, device=dev)
        return {"sel": sel, "jitter": u * (2.0 * max_cell) - max_cell}


